"""Aligned-block chunk descriptors and block fetch + score.

Port of ``verticut_tpu/ops/chunks.py``. A probe's candidate row range
``[start, start + count)`` becomes the ``blk``-aligned entry blocks it
straddles, each with a ``(lo, hi)`` window of valid rows; all chunks of all
probes of a query are flattened into one fixed budget of ``chb`` slots.
The blocks are then fetched and scored from the inline ``(id, code)`` rows
(:func:`fetch_score_blocks`) or from the compact layout's id-only rows and
the shared code array (:func:`fetch_score_idrows`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from verticut_tpu_torch.bits import popcount32
from verticut_tpu_torch.ops.topk import INF_DIST, INVALID_ID


def chunk_descriptors(starts: torch.Tensor, counts: torch.Tensor, *, blk: int,
                      chb: int, n_blocks: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
    """``starts/counts: int32[Q, H]`` (count 0 = empty probe) ->
    ``(blk_id int32[Q, CHB], lo int32[Q, CHB], hi int32[Q, CHB],
    nch int32[Q], overflow bool[Q])``.

    Chunk slot ``h`` covers entry rows ``[blk_id*blk + lo, blk_id*blk +
    hi)``; slots past the query's chunk count have ``lo == hi`` and a
    clipped ``blk_id``. ``overflow`` is set when a query needs more than
    ``chb`` chunks. The owning probe of each slot is found by a batched
    ``searchsorted`` over the cumulative chunk counts, where the reference
    masks a ``[Q, H, CHB]`` compare; the result is the same."""
    q, h_probes = starts.shape
    ends = starts + counts
    ablk0 = starts // blk
    nch_p = torch.where(counts > 0, (ends + (blk - 1)) // blk - ablk0, 0)
    cum = torch.cumsum(nch_p, dim=-1, dtype=torch.int32)          # [Q, H]
    base = cum - nch_p                                            # exclusive
    total = cum[:, -1]
    h = torch.arange(chb, dtype=torch.int32, device=starts.device)
    hq = h[None, :].expand(q, chb).contiguous()
    owner = torch.searchsorted(cum.contiguous(), hq, right=True)  # [Q, CHB]
    owned = owner < h_probes
    oc = owner.clamp(max=h_probes - 1)

    def sel(payload):  # the owning segment's value; 0 for unowned slots
        return torch.where(owned, torch.gather(payload, 1, oc), 0)

    blk_id = h + sel(ablk0 - base)
    lo = (sel(starts) - blk_id * blk).clamp(0, blk)
    hi = (sel(ends) - blk_id * blk).clamp(0, blk)
    blk_id = blk_id.clamp(0, n_blocks - 1)
    nch = torch.clamp(total, max=chb)
    return blk_id, lo, hi, nch, total > chb


def fetch_score_blocks(entry_rows: torch.Tensor, blk_id: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor,
                       queries: torch.Tensor, *, blk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the descriptor blocks of word-major ``(id, code)`` entry rows
    and score them against the queries.

    ``entry_rows: int32[NB, blk*RW]`` (lane ``w*blk + r`` = word ``w`` of
    entry ``r``; word 0 = id, pad id -1), ``blk_id/lo/hi: int32[Q, CHB]``,
    ``queries: int32[Q, W]`` -> ``(dist int32[Q, CHB*blk], id int32[Q,
    CHB*blk])`` with invalid slots at ``(INF_DIST, -1)``."""
    w = queries.shape[-1]
    nq, chb = blk_id.shape
    g = entry_rows[blk_id.long()]                            # [Q,CHB,blk*RW]
    ids = g[..., 0:blk]
    dist = torch.zeros_like(ids)
    for j in range(w):
        x = g[..., (1 + j) * blk:(2 + j) * blk] ^ queries[:, None, j:j + 1]
        dist += popcount32(x)
    pos = torch.arange(blk, dtype=torch.int32, device=blk_id.device)
    valid = (pos >= lo[..., None]) & (pos < hi[..., None]) & (ids >= 0)
    dist = torch.where(valid, dist, INF_DIST)
    ids = torch.where(valid, ids, INVALID_ID)
    return dist.reshape(nq, chb * blk), ids.reshape(nq, chb * blk)


def fetch_score_idrows(entry_idrows: torch.Tensor, codes: torch.Tensor,
                       blk_id: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, queries: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compact layout's fetch + score: gather the descriptor blocks of
    id-only rows (``int32[NBc, blk]``, pad id -1), then each candidate's
    code from the id-ordered ``codes`` ``int32[N, W]``, and score them.
    Same outputs as :func:`fetch_score_blocks`. The chunk axis is cut into
    slices so the gathered ``[Q, slice, blk, W]`` codes stay under 2^23
    words, as the reference slices it."""
    nq, chb = blk_id.shape
    blk = entry_idrows.shape[1]
    n, w = codes.shape
    pos = torch.arange(blk, dtype=torch.int32, device=blk_id.device)
    sl = max(8, (1 << 23) // max(nq * blk * w, 1))
    d_parts, i_parts = [], []
    for c0 in range(0, chb, sl):
        cid = entry_idrows[blk_id[:, c0:c0 + sl].long()]      # [Q, s, blk]
        g = codes[cid.clamp(0, n - 1).long()]                  # [Q,s,blk,W]
        dist = popcount32(g ^ queries[:, None, None, :]).sum(
            dim=-1, dtype=torch.int32)
        ok = ((pos >= lo[:, c0:c0 + sl, None])
              & (pos < hi[:, c0:c0 + sl, None]) & (cid >= 0))
        d_parts.append(torch.where(ok, dist, INF_DIST).reshape(nq, -1))
        i_parts.append(torch.where(ok, cid, INVALID_ID).reshape(nq, -1))
    return torch.cat(d_parts, dim=-1), torch.cat(i_parts, dim=-1)
