"""Bounded top-k selection and dedup merges over packed ``int64`` keys.

The port of ``verticut_tpu/ops/topk.py`` that the search paths use. A pool
per query is
``(dist int32[Q, P], id int32[Q, P])`` ascending by ``(dist, id)``; empty
slots hold ``(INF_DIST, -1)``. Candidates are selected as ascending keys
``dist << 24 | id`` (:func:`pack_keys`), unique per element, so
``torch.topk``'s undefined tie order never shows: equal keys are equal
values. Ids must stay below 2^24 (:func:`can_pack`); above that the
``_pos`` selections keep explicit ``(dist, id)`` strips and select on
``dist << 32 | id`` keys instead, in the same order.

The brute-force scans select on wider keys, ``dist << 32 | id``
(:func:`chunk_topk_affine`, :func:`merge_topk`), which hold any int32 id.
"""

from __future__ import annotations

import torch

INF_DIST = 0x7FFFFFFF
INVALID_ID = -1

#: bits of id payload under the distance field of a packed selection key
PACKED_ID_BITS = 24
_ID_MASK = (1 << PACKED_ID_BITS) - 1
#: the invalid key: above every valid ``dist << 24 | id`` key (dist <= 254)
SENTINEL_KEY = 0xFFFFFFFF

#: the invalid scan key: above every valid ``dist << 32 | id`` key
SCAN_SENTINEL = 1 << 62
_INT64_MAX = (1 << 63) - 1

#: widest chunk axis the chunk-min pre-selection admits, and the widest
#: strip it selects (the reference's _CHUNKMIN_MAX_CHB and _TOPK_WIDE;
#: kept so both packages take the same path at the same shapes)
_CHUNKMIN_MAX_CHB = 1024
_TOPK_WIDE = 1536


def pack_keys(dist: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Ascending ``int64`` keys ``dist << 24 | id``; invalid slots
    (``id < 0``) get :data:`SENTINEL_KEY`. The reference selects the
    complements ``~(dist << 24 | id)`` as uint32, largest first."""
    k = (dist.to(torch.int64) << PACKED_ID_BITS) | ids.to(torch.int64)
    return torch.where(ids >= 0, k, SENTINEL_KEY)


def unpack_keys(keys: torch.Tensor):
    """Inverse of :func:`pack_keys`: ``(dist int32, id int32)`` with
    sentinel slots at ``(INF_DIST, -1)``."""
    invalid = keys == SENTINEL_KEY
    d = (keys >> PACKED_ID_BITS).to(torch.int32)
    i = (keys & _ID_MASK).to(torch.int32)
    return (torch.where(invalid, INF_DIST, d),
            torch.where(invalid, INVALID_ID, i))


def empty_pool(n_queries: int, pool_size: int, device=None):
    """Fresh pool: all slots invalid."""
    return (torch.full((n_queries, pool_size), INF_DIST, dtype=torch.int32,
                       device=device),
            torch.full((n_queries, pool_size), INVALID_ID, dtype=torch.int32,
                       device=device))


def can_pack(max_id: int, max_dist: int) -> bool:
    # strict: the all-ones 32-bit key is the invalid sentinel
    return max_id < (1 << PACKED_ID_BITS) and max_dist < (
        1 << (32 - PACKED_ID_BITS)) - 1


def select_asc(keys: torch.Tensor, m: int) -> torch.Tensor:
    """Smallest ``m`` keys of the last axis, ascending; pads with
    :data:`SENTINEL_KEY` when the axis is shorter than ``m``. The
    counterpart of the reference's ``select_desc`` over inverted keys."""
    w = keys.shape[-1]
    kk = min(m, w)
    out = torch.topk(keys, kk, dim=-1, largest=False, sorted=True).values
    if kk < m:
        pad = out.new_full(out.shape[:-1] + (m - kk,), SENTINEL_KEY)
        out = torch.cat([out, pad], dim=-1)
    return out


def table_topk_packed(cand_dist: torch.Tensor, cand_id: torch.Tensor,
                      p: int) -> torch.Tensor:
    """One table's top-``p`` candidates as ascending packed keys,
    ``[Q, C] -> int64[Q, min(p, C)]``. Needs :func:`can_pack` bounds."""
    kc = pack_keys(cand_dist, cand_id)
    return select_asc(kc, min(p, kc.shape[-1]))


def table_topk_chunkmin_packed(cand_dist: torch.Tensor, cand_id: torch.Tensor,
                               p: int, blk: int) -> torch.Tensor:
    """One table's top-``p`` via chunk-min pre-selection.

    ``cand_* [Q, C]`` arrive as ``C = chb * blk`` slots in chunk-major
    order, and within one table at one radius step every id appears at most
    once. So the top-``p`` keys lie in the ``p`` chunks with the smallest
    chunk minima: select those chunks, gather them, select ``p`` keys from
    the narrow strip. Falls back to :func:`table_topk_packed` at the same
    shapes as the reference (strip not well under the candidate width, or
    too many chunks)."""
    q, c = cand_dist.shape
    chb = c // blk
    if (4 * p * blk > c or c % blk or chb > _CHUNKMIN_MAX_CHB
            or p > _TOPK_WIDE):
        return table_topk_packed(cand_dist, cand_id, p)
    kc3 = pack_keys(cand_dist, cand_id).reshape(q, chb, blk)
    cmin = kc3.amin(dim=-1)                                     # [Q, chb]
    # chunks tie only when both hold no valid key, and then either choice
    # contributes nothing
    ci = torch.topk(cmin, p, dim=-1, largest=False).indices
    g = torch.gather(kc3, 1, ci[:, :, None].expand(q, p, blk))
    return select_asc(g.reshape(q, p * blk), p)


def merge_strips_packed(pool_dist: torch.Tensor, pool_id: torch.Tensor,
                        strips: torch.Tensor, n_copies: int):
    """Dedup merge of the pool with per-table strips (``int64[Q, S]``
    ascending keys from the table selections). ``n_copies`` bounds the
    copies one id can have across pool and strips (n_tables + 1). A
    duplicate is a bitwise-equal key: select, blank adjacent repeats,
    select again."""
    p = pool_dist.shape[-1]
    keys = torch.cat([pack_keys(pool_dist, pool_id), strips], dim=-1)
    m = min(p * n_copies, keys.shape[-1])
    top = select_asc(keys, m)
    dup = torch.zeros_like(top, dtype=torch.bool)
    dup[:, 1:] = (top[:, 1:] == top[:, :-1]) & (top[:, 1:] != SENTINEL_KEY)
    top = torch.where(dup, SENTINEL_KEY, top)
    return unpack_keys(select_asc(top, p))


def _pair_keys(cand_dist: torch.Tensor, cand_id: torch.Tensor) -> torch.Tensor:
    """Ascending keys ``dist << 32 | id`` for ids of any int32 size;
    invalid slots (``id < 0``) get :data:`SCAN_SENTINEL`."""
    k = (cand_dist.to(torch.int64) << 32) | cand_id.to(torch.int64)
    return torch.where(cand_id >= 0, k, SCAN_SENTINEL)


def _unpair_keys(top: torch.Tensor):
    """Inverse of :func:`_pair_keys`, sentinel slots at ``(INF_DIST,
    -1)``."""
    invalid = top == SCAN_SENTINEL
    return (torch.where(invalid, INF_DIST, top >> 32).to(torch.int32),
            torch.where(invalid, INVALID_ID, top & 0xFFFFFFFF).to(torch.int32))


def table_topk_pos(cand_dist: torch.Tensor, cand_id: torch.Tensor, p: int):
    """One table's top-``p`` candidates for ids of any size:
    ``[Q, C] -> (dist int32[Q, min(p, C)], id int32[Q, min(p, C)])``,
    ascending by ``(dist, id)`` (``dist << 32 | id`` keys, unique within
    one table at one step). The reference selects on ``(dist, slot)``
    uint32 keys instead, which keeps the table's first slots, not its
    smallest ids, at an equal distance, and whose 8-bit distance field
    wraps at 256 (ROADMAP.md Queue 3)."""
    keys = _pair_keys(cand_dist, cand_id)
    return _unpair_keys(torch.topk(keys, min(p, keys.shape[-1]), dim=-1,
                                   largest=False, sorted=True).values)


def table_topk_chunkmin_pos(cand_dist: torch.Tensor, cand_id: torch.Tensor,
                            p: int, blk: int):
    """:func:`table_topk_chunkmin_packed`'s chunk-min pre-selection on
    ``dist << 32 | id`` keys: the result equals :func:`table_topk_pos`,
    and falls back to it at the reference's shapes."""
    q, c = cand_dist.shape
    chb = c // blk
    if (4 * p * blk > c or c % blk or chb > _CHUNKMIN_MAX_CHB
            or p > _TOPK_WIDE):
        return table_topk_pos(cand_dist, cand_id, p)
    kc3 = _pair_keys(cand_dist, cand_id).reshape(q, chb, blk)
    ci = torch.topk(kc3.amin(dim=-1), p, dim=-1, largest=False).indices
    g = torch.gather(kc3, 1, ci[:, :, None].expand(q, p, blk))
    return _unpair_keys(select_asc(g.reshape(q, p * blk), p))


def merge_strips_dedup_pos(pool_dist: torch.Tensor, pool_id: torch.Tensor,
                           strip_dist: torch.Tensor, strip_id: torch.Tensor):
    """Dedup merge of the pool with explicit ``(dist, id)`` strips, for ids
    of any size. One sort of ``id << 32 | dist`` keys (invalid ids last)
    brings the copies of an id together, all but the first are dropped,
    and the ``p`` smallest ``dist << 32 | id`` keys of the rest, ascending,
    form the new pool: equal distances go to the smaller id, as in the
    reference's merge, whose slots follow the id-sorted order."""
    p = pool_dist.shape[-1]
    d = torch.cat([pool_dist, strip_dist], dim=-1).to(torch.int64)
    i = torch.cat([pool_id, strip_id], dim=-1).to(torch.int64)
    by_id = torch.sort(torch.where(i >= 0, (i << 32) | d, _INT64_MAX),
                       dim=-1).values
    sid, sd = by_id >> 32, by_id & 0xFFFFFFFF
    keep = by_id != _INT64_MAX
    keep[:, 1:] &= sid[:, 1:] != sid[:, :-1]
    top = select_asc(torch.where(keep, (sd << 32) | sid, SCAN_SENTINEL),
                     min(p, d.shape[-1]))
    out_d, out_i = _unpair_keys(top)
    if out_d.shape[-1] < p:
        pad = p - out_d.shape[-1]
        out_d = torch.nn.functional.pad(out_d, (0, pad), value=INF_DIST)
        out_i = torch.nn.functional.pad(out_i, (0, pad), value=INVALID_ID)
    return out_d, out_i


def kth_stats(pool_dist: torch.Tensor, pool_id: torch.Tensor, k: int):
    """(pool has >= k valid entries, distance of the kth entry) per query."""
    return pool_id[:, k - 1] >= 0, pool_dist[:, k - 1]


def chunk_topk_affine(dists: torch.Tensor, base: int, k: int) -> torch.Tensor:
    """One corpus chunk's smallest ``k`` pairs for position-affine ids
    (``id = base + position``): ``int32[Q, T] -> int64[Q, min(k, T)]``
    ascending keys ``dist << 32 | id``.

    The counterpart of the reference's ``chunk_topk_affine``. The key is
    unique per element, so ties go to the lower id, the reference's order,
    and it holds any int32 id, so no ``can_pack`` branch exists. The
    reference masks positions ``>= n_valid`` of a padded last chunk; the
    port's scans pad nothing (their last chunk is shorter), so there is no
    mask."""
    t = dists.shape[-1]
    ids = torch.arange(base, base + t, device=dists.device)
    keys = (dists.to(torch.int64) << 32) | ids
    return torch.topk(keys, min(k, t), dim=-1, largest=False,
                      sorted=True).values


def merge_topk(pool: torch.Tensor, keys: torch.Tensor, k: int) -> torch.Tensor:
    """A scan's running pool of ascending ``dist << 32 | id`` keys merged
    with one chunk's: the smallest ``k`` of both, ascending. No dedup: a
    scan sees each id once (the counterpart of the reference's
    ``merge_topk_packed`` and ``merge_topk``)."""
    both = torch.cat([pool, keys], dim=-1)
    return torch.topk(both, min(k, both.shape[-1]), dim=-1, largest=False,
                      sorted=True).values
