"""Exact brute-force top-k scans.

Port of the main-path scans of ``verticut_tpu/ops/hamming.py``:

* :func:`scan_blockmin` — block-min pre-selection. Pass 1 computes each
  query's minimum distance over every ``block`` consecutive codes (the
  blockmin kernel on CUDA, its plain twin on the CPU); the ``k`` blocks
  with the smallest ``(min, block)`` keys provably hold the exact
  ``(dist, id)`` top-k; only those are gathered and rescored.
* :func:`scan_popcount` — chunked full distance matrices and sorts: the
  independent oracle, sharing no selection code with the engine.

Both slice the query batch so their temporaries stay bounded: the
``[Q, nb]`` block-min matrix alone is 2.5 GB at 10M codes, Q = 8192,
block 128.
"""

from __future__ import annotations

import torch

from verticut_tpu_torch.codes import hamming_distance, pairwise_hamming
from verticut_tpu_torch.ops.topk import INF_DIST, INVALID_ID, select_asc

#: cap on elements per query slice: block-min keys in pass 1, gathered
#: code words in the rescore
SLICE_ELEMS = 1 << 27
#: invalid rescore / oracle key: above every ``dist << 32 | id``
_SCAN_SENTINEL = 1 << 62


def _decode(top: torch.Tensor, k: int):
    """``dist << 32 | id`` keys ``[Q, kk]`` -> ``(dist, id)`` padded to k."""
    invalid = top == _SCAN_SENTINEL
    d = torch.where(invalid, INF_DIST, top >> 32).to(torch.int32)
    i = torch.where(invalid, INVALID_ID, top & 0xFFFFFFFF).to(torch.int32)
    kk = top.shape[-1]
    if kk < k:
        d = torch.cat([d, d.new_full((d.shape[0], k - kk), INF_DIST)], -1)
        i = torch.cat([i, i.new_full((i.shape[0], k - kk), INVALID_ID)], -1)
    return d, i


def _rescore_blocks(queries: torch.Tensor, db: torch.Tensor, n: int,
                    bidx: torch.Tensor, k: int, block: int):
    """Gather the selected blocks of the row-major corpus, rescore them
    exactly, and select the ``(dist, id)`` top-k of the narrow strip.
    Keys carry the global row, so the strip needs no particular order."""
    q = queries.shape[0]
    kb = bidx.shape[1]
    pos = (bidx.to(torch.int64)[:, :, None] * block
           + torch.arange(block, device=db.device))           # [Q, kb, blk]
    g = db[pos.clamp(max=n - 1)]                            # [Q, kb, blk, W]
    d = hamming_distance(g, queries[:, None, None, :])
    keys = torch.where(pos < n, (d.to(torch.int64) << 32) | pos,
                       _SCAN_SENTINEL).reshape(q, kb * block)
    return _decode(select_asc(keys, min(k, kb * block)), k)


def scan_blockmin(queries: torch.Tensor, db: torch.Tensor, k: int,
                  block: int = 512):
    """Exact top-k ``([Q, k], [Q, k])`` ascending by ``(dist, id)`` over
    the row-major ``int32[N, W]`` corpus, by block-min pre-selection.

    Selection proof (as in the reference): if a top-k winner lay in an
    unselected block, each of the k selected blocks would hold an element
    with a smaller distance, or an equal one at a smaller id, so k
    elements would order before it."""
    from verticut_tpu_torch.kernels.blockmin import blockmin
    q, w = queries.shape
    n = db.shape[0]
    nb = -(-n // block)
    if nb == 0 or q == 0:
        return _decode(torch.empty((q, 0), dtype=torch.int64,
                                   device=queries.device), k)
    kb = min(k, nb)
    idx_bits = max(1, (nb - 1).bit_length())
    biota = torch.arange(nb, dtype=torch.int64, device=db.device)
    qs = max(1, SLICE_ELEMS // max(nb, kb * block * w))
    parts_d, parts_i = [], []
    for q0 in range(0, q, qs):
        sq = queries[q0:q0 + qs]
        bm = blockmin(sq, db, n, block)                           # [s, nb]
        keys = (bm.to(torch.int64) << idx_bits) | biota
        bidx = select_asc(keys, kb) & ((1 << idx_bits) - 1)
        del bm, keys
        d, i = _rescore_blocks(sq, db, n, bidx, k, block)
        parts_d.append(d)
        parts_i.append(i)
    return torch.cat(parts_d), torch.cat(parts_i)


def scan_popcount(queries: torch.Tensor, db: torch.Tensor, k: int,
                  chunk: int = 65536):
    """Exact top-k by full distance matrices over corpus chunks, each
    chunk's keys sorted in full and merged into a running pool."""
    q, w = queries.shape
    n = db.shape[0]
    ch = max(1, min(chunk, SLICE_ELEMS // 4 // max(q * w, 1)))
    pool = torch.full((q, 0), _SCAN_SENTINEL, dtype=torch.int64,
                      device=queries.device)
    for c0 in range(0, n, ch):
        c1 = min(c0 + ch, n)
        d = pairwise_hamming(queries, db[c0:c1])
        keys = ((d.to(torch.int64) << 32)
                | torch.arange(c0, c1, device=db.device))
        keys = torch.sort(keys, dim=-1).values[:, :k]
        pool = torch.sort(torch.cat([pool, keys], -1), dim=-1).values[:, :k]
    return _decode(pool, k)
