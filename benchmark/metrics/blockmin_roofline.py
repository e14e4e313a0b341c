"""blockmin_roofline: the blockmin kernel's share of its roofline, in %,
at the cell's scan shape: ``scan_queries`` queries of the cell's traffic
(the cell file's key; none, and the metric is left out) over the whole
corpus at block 512, through the public wrapper
``verticut_tpu_torch.kernels.blockmin.blockmin``, one call per 2^27
corpus rows (one call up to 134M codes). Timed by CUDA events over the whole corpus, the median of
three passes after one warm pass; the bound is
``roofline.hamming_blockmin``'s work at the card's published peaks.
On several cards: rank 0's card, over the whole corpus, which rank 0
keeps, read after the other ranks have finished."""

import statistics
import sys

import torch

from benchmark import roofline

BLOCK = 512
CHUNK = 1 << 27
PASSES = 3


def read(run):
    nq = run.cell.params.get("scan_queries")
    if not nq or run.device.type != "cuda" or run.trace is None:
        return None
    from verticut_tpu_torch.kernels.blockmin import blockmin
    corpus = run.corpus
    queries = run.probe_batch(int(nq)).contiguous()
    n, w = corpus.shape

    def one_pass():
        for c0 in range(0, n, CHUNK):
            rows = corpus[c0:c0 + CHUNK]
            blockmin(queries, rows, rows.shape[0], BLOCK)

    one_pass()
    times = []
    for _ in range(PASSES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one_pass()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    t = statistics.median(times)
    bound, by = roofline.bound_s(
        roofline.hamming_blockmin(int(nq), n, 32 * w, BLOCK),
        torch.cuda.get_device_name(run.device))
    print(f"bench: blockmin {nq} x {n} block {BLOCK}: {t * 1e3:.3f} ms, "
          f"bound {bound * 1e3:.3f} ms by {by}", file=sys.stderr)
    return 100.0 * bound / t
