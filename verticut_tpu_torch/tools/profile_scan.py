"""Component profile of the block-min scan (the uniform cells' scan tier):
the port's twin of ``tools/profile_scan.py``.

Splits ``ops/hamming.scan_blockmin`` into its costs on uniform queries
(``random_codes(7, Q)``) over N clustered codes made on the device:

* ``kernel``: the blockmin kernel over the corpus chunk by chunk, as pass
  1 calls it, with no selection;
* ``pass1``: the kernel and the folded block selection
  (``hamming.select_blocks``), no rescore;
* ``rescore``: ``hamming._rescore_blocks`` of the blocks pass 1 selected
  (the ``(block, W)`` slice gathers, popcount and strip selection);
* ``full``: ``scan_blockmin`` end to end, on the search paths' instance;

over blocks {512, 256, 128} and both blockmin instances: ``tensor`` (int8
``wgmma``, every search path's) and ``generic`` (CUDA-core popcount).
The instance takes the place of the JAX tool's ``acc`` (bf16 or int8
operands of one TPU kernel): the port has one operand type per instance
(``kernels/blockmin.py``). Beside each kernel time stands its bound
(``bound_ms``: the larger of the int8 tensor-core operations at the
card's peak and the bytes at its memory rate, ``_profile.blockmin_bound``).

Checks (the tool exits 1 if one fails): per block and instance, pass 1
then the rescore equals ``scan_blockmin`` in dists and ids, and the two
instances' kernel outputs are equal on the first chunk.

Timing: ``(t_R - t_1) / (R - 1)`` at R = 3 (``_profile.rep_ms``); one more
call under ``torch.profiler`` gives each row's launches, device ms and
``cudaLaunchKernel`` host seconds. The JAX tool's ``widerow*_gather`` rows
time row gathers off the rescore layout ``codes_t`` feeds on the TPU; the
port keeps no transposed copy, so they are left out, and the JSON says so.

Usage: python -m verticut_tpu_torch.tools.profile_scan [N] [K] [--q 8192]
[--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from verticut_tpu_torch import codes
from verticut_tpu_torch.bits import as_codes, entry_device
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.ops import hamming
from verticut_tpu_torch.tools import _profile
from verticut_tpu_torch.tools._profile import Rows

BLOCKS = (512, 256, 128)
LEFT_OUT = {
    "widerow2048B_gather_ms, widerow8192B_gather_ms":
        "row gathers off the TPU's transposed rescore copy (codes_t, "
        "rescore_rows_layout); the port keeps no such copy",
    "bf16_mac_floor_ms": "the TPU's bf16 MXU floor; the card's bound of "
                         "each block's kernel is bound_ms",
}


def kernel_only(queries: torch.Tensor, db: torch.Tensor, block: int,
                which: str) -> torch.Tensor:
    """The blockmin kernel over the corpus in pass 1's chunks, no
    selection; returns the first chunk's minima."""
    n = db.shape[0]
    nb = -(-n // block)
    cb = hamming._fold_blocks(queries.shape[0], block)
    first = None
    for c0 in range(0, nb, cb):
        rows = db[c0 * block:min((c0 + cb) * block, n)]
        bm = kb.blockmin(queries, rows, rows.shape[0], block, which)
        first = bm if first is None else first
    return first


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", type=int, nargs="?", default=16_000_000)
    ap.add_argument("k", type=int, nargs="?", default=10)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    n, k, q, bits = args.n, args.k, args.q, 128
    w = bits // 32
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    _profile.log(f"device: {name}  n={n} q={q} k={k}")
    db = codes.clustered_codes_device(0, n, bits, n_clusters=max(1, n // 200),
                                      flip_p=0.02, device=dev)
    queries = as_codes(codes.random_codes(7, q, bits), dev)
    rows = Rows(dev)
    out = {"metric": "profile_scan", "n": n, "q": q, "k": k}
    bounds, checks = {}, {}

    def timed(key, fn):
        return rows.add(key, _profile.rep_ms(fn, dev, 3, tries=2), fn)

    for block in BLOCKS:
        bound, by = _profile.blockmin_bound(q, n, w, block)
        bounds[f"block{block}"] = {"bound_ms": bound, "bound_by": by}
        first = {}
        for which in kb.INSTANCES:
            key = f"block{block}_{which}"
            t_k = timed(f"{key}_kernel_ms",
                        lambda: kernel_only(queries, db, block, which))
            first[which] = kernel_only(queries, db, block, which)
            t_p1 = timed(f"{key}_pass1_ms", lambda: hamming.select_blocks(
                queries, db, k, block, which))
            _profile.log(f"block={block:4d} instance={which}: kernel "
                         f"{t_k:9.3f} ms  pass1 {t_p1:9.3f} ms (bound "
                         f"{bound:.3f} ms, {by})")
            bidx = hamming.select_blocks(queries, db, k, block, which)
            d1, i1 = hamming._rescore_blocks(queries, db, n, bidx, k, block)
            d0, i0 = hamming.scan_blockmin(queries, db, k, block=block,
                                           which=which)
            checks[f"{key} pass1+rescore equals scan_blockmin"] = bool(
                torch.equal(d0, d1) and torch.equal(i0, i1))
        checks[f"block{block} kernel tensor equals generic"] = bool(
            torch.equal(first["tensor"], first["generic"]))
        t_r = timed(f"block{block}_rescore_ms",
                    lambda: hamming._rescore_blocks(queries, db, n, bidx, k,
                                                    block))
        t_f = timed(f"block{block}_full_ms",
                    lambda: hamming.scan_blockmin(queries, db, k,
                                                  block=block))
        _profile.log(f"block={block:4d} rescore {t_r:9.3f} ms  full "
                     f"{t_f:9.3f} ms")
    out.update(rows.ms)
    out.update({"bound_ms": bounds, "profile": rows.prof, "checks": checks,
                "left_out": LEFT_OUT, "device": name})
    print(json.dumps(out), flush=True)
    if _profile.fail_on(checks, "profile_scan"):
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
