"""Brute-force exact K-NN scan: the ground-truth oracle and the fallback.

Port of ``verticut_tpu/search/linear.py``. Ties at the kth distance
resolve by ascending id.
"""

from __future__ import annotations

import torch

from verticut_tpu_torch.bits import as_codes, entry_device
from verticut_tpu_torch.ops import hamming

METHODS = ("auto", "blockmin", "popcount", "matmul", "pallas")


def linear_search(queries, db, k: int, method: str = "auto",
                  chunk: int = 65536):
    """Exact top-k ``(dists int32[Q, k], ids int32[Q, k])`` ascending by
    ``(dist, id)``, on ``db``'s device if it is a tensor, else on that of
    ``queries`` if it is one, else on the card (raising where there is
    none).

    ``method``, under the reference's names:

    * ``"blockmin"`` — block-min pre-selection (the blockmin kernel on a
      GPU);
    * ``"pallas"`` — full distance matrices from the pairwise kernel, the
      hand-written counterpart of the reference's Pallas kernel K4;
    * ``"matmul"`` — full distance matrices as a ±1 GEMM;
    * ``"popcount"`` — full distance matrices and sorts (the oracle);
    * ``"auto"`` — blockmin on CUDA, popcount on the CPU, as the reference
      picks blockmin on a TPU and popcount elsewhere.

    The reference's ``db_t`` and ``db_rows`` (its transposed and blocked
    corpus copies) have no counterpart: the port scans the row-major
    corpus."""
    db = as_codes(db, entry_device(None, db, queries))
    queries = as_codes(queries, db.device).contiguous()
    chunk = min(chunk, max(db.shape[0], 8))
    if method == "auto":
        method = "blockmin" if db.is_cuda else "popcount"
    if method == "blockmin":
        # narrower blocks at large k (the rescore gathers k blocks per
        # query), and query slices that bound the [Q, k, block, W] rescore
        # buffer, as the reference slices them. The reference also passes
        # its clamped chunk, which raises for 4096 < N < 65536 unless N is
        # a multiple of the block (ROADMAP.md Queue 3); the port's scan
        # does not depend on chunk, so none is passed
        block = 512 if k <= 32 else 128
        per_q = max(1, k * block * db.shape[1] * 4)
        max_q = max(256, (1 << 31) // per_q)
        nq = queries.shape[0]
        parts = [hamming.scan_blockmin(queries[lo:lo + max_q], db, k,
                                       block=block)
                 for lo in range(0, max(nq, 1), max_q)]
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    if method == "popcount":
        return hamming.scan_popcount(queries, db, k, chunk=chunk)
    if method == "matmul":
        return hamming.scan_matmul(queries, db, k, chunk=chunk)
    if method == "pallas":
        return hamming.scan_pallas(queries, db, k, chunk=max(chunk, 512))
    raise ValueError(f"unknown method {method!r} (one of {METHODS})")
