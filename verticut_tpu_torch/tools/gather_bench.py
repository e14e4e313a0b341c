"""Gather cost per slice and per row on the device: the port's twin of
``tools/gather_bench.py``.

Sizes the scan's rescore (``ops/hamming._rescore_blocks``) from the
gathers the port's row-major layout admits, over a random ``int32[N, 4]``
corpus (16M codes, 256 MB, by default) and random slice indices
``[Q, C]`` below ``N / 1024`` for (Q, C) in ``--qc``:

* ``rowmajor (blk,4) slices``: ``blk`` consecutive rows from each index
  times ``blk``, for blk in {128, 512} (skipped where the gathered
  ``[Q, C, blk, 4]`` would pass 6 GiB, as in the JAX tool);
* ``row gather``: the ``Q * C`` single rows at the indices.

Each cost is ``(t_R - t_1) / (R - 1)`` at R = 6 (``_profile.rep_ms``),
reported as ms and ns per slice or row. Each gather is checked once against
numpy's indexing of the same rows on the first 64 queries; a mismatch
exits 1. The JAX tool's ``transposed (8,128) slices`` rows gather off the
TPU's transposed corpus copy, which the port does not keep: they are left
out, and the JSON says so.

Usage: python -m verticut_tpu_torch.tools.gather_bench [--n 16777216]
[--qc 8192x256 8192x64 1024x512] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from verticut_tpu_torch.bits import entry_device
from verticut_tpu_torch.tools import _profile

W = 4
R = 6
#: the largest gathered slab timed, as in the JAX tool
MAX_BYTES = 6 << 30
LEFT_OUT = {
    "[QxC] transposed (8,128) slices":
        "(8, 128) slices off the TPU's transposed corpus copy db_t, "
        "which the port does not keep",
}


def slice_gather(db: torch.Tensor, idx: torch.Tensor, blk: int):
    """``[Q, C, blk, W]``: the ``blk`` rows from each ``idx * blk``."""
    pos = (idx.long() * blk)[..., None] + torch.arange(blk, device=db.device)
    return db[pos]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=16 * 1024 * 1024)
    ap.add_argument("--qc", nargs="+", default=["8192x256", "8192x64",
                                                "1024x512"],
                    help="QxC: queries and slices per query")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    n = args.n
    rng = np.random.default_rng(0)
    db_np = rng.integers(-(1 << 31), 1 << 31, (n, W), dtype=np.int64
                         ).astype(np.int32)
    db = torch.from_numpy(db_np).to(dev)
    results, checks = {}, {}
    for qc in args.qc:
        q, c = (int(x) for x in qc.lower().split("x"))
        n_sl = q * c
        idx_np = rng.integers(0, max(1, n // 1024), (q, c)).astype(np.int32)
        idx = torch.from_numpy(idx_np).to(dev)
        for blk in (128, 512):
            if n_sl * blk * W * 4 > MAX_BYTES:
                continue
            ms = _profile.rep_ms(lambda: slice_gather(db, idx, blk), dev, R)
            key = f"[{q}x{c}] rowmajor ({blk},4) slices"
            results[key] = {"ms": ms, "ns_per_slice": ms * 1e6 / n_sl}
            _profile.log(f"  {key:40s} {ms:8.3f} ms  "
                         f"{ms * 1e6 / n_sl:7.2f} ns/slice")
            got = slice_gather(db, idx[:64], blk).cpu().numpy()
            pos = idx_np[:64].astype(np.int64)[..., None] * blk + np.arange(blk)
            checks[f"{key} equals numpy"] = bool(
                np.array_equal(got, db_np[pos]))
        ms = _profile.rep_ms(lambda: db[idx.reshape(-1).long()], dev, R)
        key = f"[{q}x{c}] row gather"
        results[key] = {"ms": ms, "ns_per_row": ms * 1e6 / n_sl}
        _profile.log(f"  {key:40s} {ms:8.3f} ms  {ms * 1e6 / n_sl:7.2f} "
                     f"ns/row")
        got = db[idx[:64].reshape(-1).long()].cpu().numpy()
        checks[f"{key} equals numpy"] = bool(
            np.array_equal(got, db_np[idx_np[:64].reshape(-1)]))
    rec = {"metric": "gather_bench", "n": n, "res": results,
           "checks": checks, "left_out": LEFT_OUT, "device": str(dev)}
    print(json.dumps(rec), flush=True)
    if _profile.fail_on(checks, "gather_bench"):
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
