"""Brute-force exact K-NN scan: the ground-truth oracle and the fallback.

Port of ``verticut_tpu/search/linear.py``. Ties at the kth distance
resolve by ascending id.
"""

from __future__ import annotations

from verticut_tpu_torch.bits import as_codes
from verticut_tpu_torch.ops import hamming


def linear_search(queries, db, k: int, method: str = "auto",
                  chunk: int = 65536):
    """Exact top-k ``(dists int32[Q, k], ids int32[Q, k])`` ascending by
    ``(dist, id)``, on ``db``'s device.

    ``method``: ``"blockmin"`` (block-min pre-selection; the CUDA kernel on
    a GPU), ``"popcount"`` (full distance matrices), or ``"auto"``:
    blockmin on CUDA, popcount on the CPU, as the reference picks blockmin
    on a TPU and popcount elsewhere."""
    db = as_codes(db)
    queries = as_codes(queries, db.device)
    if method == "auto":
        method = "blockmin" if db.is_cuda else "popcount"
    if method == "blockmin":
        # narrower blocks at large k: the rescore gathers k blocks per query
        return hamming.scan_blockmin(queries, db, k,
                                     block=512 if k <= 32 else 128)
    if method == "popcount":
        return hamming.scan_popcount(queries, db, k, chunk=chunk)
    raise ValueError(f"unknown method {method!r} (the port has 'auto', "
                     "'blockmin' and 'popcount')")
