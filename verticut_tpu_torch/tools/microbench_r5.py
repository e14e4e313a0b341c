"""Rescore-gather formulations and k = 100 selection shapes on the device:
the port's twin of ``tools/microbench_r5.py``.

1. The rescore of the block-min scan at Q queries (8192) over N uniform
   codes (1M, ``random_codes(3, N)``; queries ``random_codes(7, Q)``), for
   (k, block) in {(10, 512), (100, 128), (100, 512)}, on random sorted
   block indices ``[Q, k]``: gather the k blocks of each query, popcount
   against the query, keep each query's minimum, two ways:

   * ``slice``: ``(block, W)`` slices off the row-major ``[N, W]`` corpus
     (``ops/hamming._rescore_blocks``'s gather);
   * ``rows``: rows off a blocked copy ``[N / 128, W * 128]`` (lane
     ``j * 128 + r`` = word j of code ``128 i + r``), ``block / 128`` rows
     per block.

   The two must give equal minima, or the tool exits 1. The JAX tool's
   ``dbt`` formulation gathers ``(8, block)`` slices off the TPU's
   transposed corpus copy, which the port does not keep: left out, and
   the JSON says so.
2. One table's top-p selection at the fused pipeline's shapes, ``[Q, C]``
   candidates with random distances and unique ids: ``native``,
   ``topk.table_topk_packed`` (one ``torch.topk`` of the packed keys),
   against ``cm{d}``, chunk-min pre-selection over chunks of ``d`` slots
   (the p chunks with the smallest minima, then one selection of their
   p * d keys), which must select the same keys, or the tool exits 1.

Timing: the best of three runs of 5 calls back to back with one device
sync at the end, per call (``_profile.mean_ms``).

Usage: python -m verticut_tpu_torch.tools.microbench_r5 [--n 1000000]
[--q 8192] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from verticut_tpu_torch import codes
from verticut_tpu_torch.bits import as_codes, entry_device, popcount32
from verticut_tpu_torch.ops import topk
from verticut_tpu_torch.tools import _profile

W = 4
#: (k, block) of the rescore cells
RESCORE = ((10, 512), (100, 128), (100, 512))
#: (C, p, chunk sizes d) of the selection cells
SELECT = ((1100, 100, (2, 4, 5)), (5800, 100, (8, 10, 25)),
          (1100, 10, (10, 25)), (2200, 10, (10, 22, 25)),
          (8192, 100, (8, 16, 32)))
LEFT_OUT = {
    "rescore_k{k}_b{block}_dbt_ms":
        "(8, block) slice gathers off the TPU's transposed corpus copy "
        "db_t, which the port does not keep",
}


def rescore_slice(db, queries, bidx, block):
    """Per query, the least distance over its blocks' ``(block, W)``
    slices off the row-major corpus."""
    pos = (bidx.long() * block)[..., None] + torch.arange(block,
                                                          device=db.device)
    g = db[pos.clamp(max=db.shape[0] - 1)]              # [Q, k, block, W]
    d = popcount32(g ^ queries[:, None, None, :]).sum(-1)
    return d.reshape(d.shape[0], -1).amin(-1)


def blocked_rows(db: torch.Tensor) -> torch.Tensor:
    """``[N / 128, W * 128]``: lane ``j * 128 + r`` of row i is word j of
    code ``128 i + r`` (whole 128-row units only)."""
    nb = db.shape[0] // 128
    return (db[:nb * 128].reshape(nb, 128, W).permute(0, 2, 1)
            .reshape(nb, W * 128).contiguous())


def rescore_rows(rows, queries, bidx, block):
    """:func:`rescore_slice` off the blocked copy: ``block / 128`` rows per
    block."""
    m = block // 128
    ridx = (bidx.long() * m)[..., None] + torch.arange(m, device=rows.device)
    g = rows[ridx.clamp(max=rows.shape[0] - 1)]         # [Q, k, m, W*128]
    d = torch.zeros(g.shape[:-1] + (128,), dtype=torch.int32,
                    device=rows.device)
    for j in range(W):
        d += popcount32(g[..., j * 128:(j + 1) * 128]
                        ^ queries[:, None, None, j:j + 1])
    return d.reshape(d.shape[0], -1).amin(-1)


def sel_chunkmin(dist, ids, p: int, d: int):
    """Top-p packed keys by chunk-min pre-selection over chunks of ``d``
    slots."""
    q, c = dist.shape
    kc3 = topk.pack_keys(dist, ids).reshape(q, c // d, d)
    ci = torch.topk(kc3.amin(-1), p, dim=-1, largest=False).indices
    g = torch.gather(kc3, 1, ci[:, :, None].expand(q, p, d))
    return topk.select_asc(g.reshape(q, p * d), p)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    n, q = args.n, args.q
    rng = np.random.default_rng(0)
    db = as_codes(codes.random_codes(3, n, 128), dev)
    queries = as_codes(codes.random_codes(7, q, 128), dev)
    rows = blocked_rows(db)
    out, checks = {}, {}

    # ---- 1. rescore gather formulations --------------------------------
    for k, block in RESCORE:
        nbk = max(1, n // block)
        bidx = torch.from_numpy(np.sort(rng.integers(0, nbk, (q, k)),
                                        axis=-1).astype(np.int32)).to(dev)
        res = {}
        for name, fn, src in (("slice", rescore_slice, db),
                              ("rows", rescore_rows, rows)):
            t = _profile.mean_ms(lambda: fn(src, queries, bidx, block), dev)
            out[f"rescore_k{k}_b{block}_{name}_ms"] = t
            res[name] = fn(src, queries, bidx, block)
            _profile.log(f"rescore k={k} block={block} {name:6s} {t:8.3f} ms")
        checks[f"rescore k={k} block={block} slice equals rows"] = bool(
            torch.equal(res["slice"], res["rows"]))
        del res

    # ---- 2. k=100 per-table selection shapes ---------------------------
    for c, p, ds in SELECT:
        dist = torch.from_numpy(rng.integers(0, 129, (q, c)).astype(
            np.int32)).to(dev)
        ids = torch.from_numpy(np.argsort(rng.random((q, c)), axis=-1)
                               .astype(np.int32)).to(dev)
        t = _profile.mean_ms(lambda: topk.table_topk_packed(dist, ids, p),
                             dev)
        out[f"sel_c{c}_p{p}_native_ms"] = t
        want = topk.table_topk_packed(dist, ids, p)
        _profile.log(f"sel [{q},{c}]->{p} native  {t:8.3f} ms")
        for d in ds:
            if c % d:
                continue
            t = _profile.mean_ms(lambda: sel_chunkmin(dist, ids, p, d), dev)
            out[f"sel_c{c}_p{p}_cm{d}_ms"] = t
            checks[f"sel c={c} p={p} cm{d} equals native"] = bool(
                torch.equal(sel_chunkmin(dist, ids, p, d), want))
            _profile.log(f"sel [{q},{c}]->{p} cm d={d:3d} {t:8.3f} ms")
    rec = {"metric": "microbench_r5", "n": n, "q": q, **out,
           "checks": checks, "left_out": LEFT_OUT, "device": str(dev)}
    print(json.dumps(rec), flush=True)
    if _profile.fail_on(checks, "microbench_r5"):
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
