"""Single-device batched MIH search: the fused staged driver and the loop
driver, exact and approximate.

Port of ``verticut_tpu/search/single.py``. Per radius stage and per table,
:func:`radius_step` probes the table's directory: a range directory with
every flipped prefix, whose entry blocks it fetches and scores, or a bucket
directory (dense, sorted, prefix, hash) with every flipped substring, whose
buckets :func:`expand_buckets` flattens into a fixed candidate budget. It
keeps the table's top-P, merges the strips into the pool and applies the
stop rule: the exact MIH rule, or in approximate mode a full
``k * approximate_factor`` pool.
:func:`run_pipeline` drives the stages with compaction to shrinking batch
budgets, an overflow retry ladder and a brute-force scan ladder (the
fused driver, the default); :func:`_mih_search_loop` runs one stage at a
time and compacts between them (the loop driver, ``fused=False``, and the
fall-through when no radius stage fits ``fused_max_masks``).
:func:`_apply_fallbacks` then re-runs still-overflowed queries at larger
caps and scans what remains.

The fused driver is split as the reference splits it:
:func:`mih_search_dispatch` runs the pipeline up to the packed result row
(:func:`_pack_row`) and starts its copy to the host;
:func:`mih_search_finalize` waits for the copy, decodes the row and runs
the fallbacks. :func:`mih_search` is the two back to back.

Where the reference's single device program branches with ``lax.cond``,
the port reads a scalar from the device and branches on the host (about
nine reads per batch), so a dispatch returns only once most of its device
work is done. The fused driver returns the stats as the packed row
carries them: ``radius`` saturated at 127 and ``n_probes`` at 0xFFFF; the
loop driver, as the reference's, saturates neither.

Ids of 2^24 and more do not fit the packed ``dist << 24 | id`` selection
keys: the radius step then keeps explicit ``(dist, id)`` strips (the
``_pos`` selections of :mod:`ops.topk`), as the reference does.

The reference's loop driver writes its last query's result from a pad row
when a batch is compacted twice (ROADMAP.md Queue 3); the port retires
real rows only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from verticut_tpu_torch.bits import as_codes, shr
from verticut_tpu_torch.codes import hamming_distance
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index.directory import RangeDirectory
from verticut_tpu_torch.index.mih import MIHIndex, MIHTable
from verticut_tpu_torch.ops import chunks as chunks_lib
from verticut_tpu_torch.ops import enumeration, topk
from verticut_tpu_torch.ops.hamming import scan_blockmin
from verticut_tpu_torch.search import linear as linear_lib

# Fetch-block size of the schedule's cost model (the reference's RANGE_BLK:
# 25-entry inline rows and 32-id compact rows both fit under it).
RANGE_BLK = 32

# Smallest batch that turns on the scan-dominance stage skip (diverts
# scan-dominated batches from deep enumeration to the scan ladder).
SCAN_DOMINANCE_MIN_NQ = 1024

# Largest corpus whose overflow retries may ride the scan ladder
# (overflow_to_scan): above it one scan of the corpus costs more than a
# capped re-enumeration (the reference's rule).
OVERFLOW_SCAN_MAX_N = 32_000_000


class SearchState(NamedTuple):
    pool_dist: torch.Tensor   # int32[Q, P]
    pool_id: torch.Tensor     # int32[Q, P]
    done: torch.Tensor        # bool[Q]
    radius: torch.Tensor      # int32[Q]: radius at which each query finished
    overflow: torch.Tensor    # bool[Q]: candidate budget exceeded
    n_probes: torch.Tensor    # int32[Q]: probed prefixes
    n_nonempty: torch.Tensor  # int32[Q]: non-empty probed ranges
    n_cands: torch.Tensor     # int32[Q]: candidates scored


class SearchResult(NamedTuple):
    """One batch's answers, on the host (CPU tensors), as the reference
    returns host arrays."""

    dists: torch.Tensor       # int32[Q, k] ascending
    ids: torch.Tensor         # int32[Q, k] (-1 = fewer than k results exist)
    radius: torch.Tensor      # int32[Q], saturated at 127
    n_probes: torch.Tensor    # int32[Q], saturated at 0xFFFF
    n_nonempty: torch.Tensor  # int32[Q]
    n_cands: torch.Tensor     # int32[Q]


def init_state(n_queries: int, pool_size: int, device=None) -> SearchState:
    pd, pi = topk.empty_pool(n_queries, pool_size, device)
    z = torch.zeros(n_queries, dtype=torch.int32, device=device)
    f = torch.zeros(n_queries, dtype=torch.bool, device=device)
    return SearchState(pool_dist=pd, pool_id=pi, done=f, radius=z,
                       overflow=f, n_probes=z, n_nonempty=z, n_cands=z)


def _take(state: SearchState, sel: torch.Tensor) -> SearchState:
    return SearchState(*(leaf[sel] for leaf in state))


# --------------------------------------------------------------------------
# Candidate-slot expansion: variable bucket sizes -> a fixed budget
# --------------------------------------------------------------------------

def expand_buckets(starts: torch.Tensor, counts: torch.Tensor, cap: int):
    """Flatten per-probe ``(start, count)`` ranges into ``cap`` candidate
    slots: ``int32[Q, C]`` -> ``(entry int32[Q, cap], valid bool[Q, cap],
    total int32[Q])``. Slot p of query q belongs to the probe whose
    cumulative-count interval holds p, found by a batched ``searchsorted``
    over the cumulative counts (as ``ops/chunks`` finds slot owners);
    slots past ``min(total, cap)`` are invalid and hold ``entry = p``, as
    the reference's default compare-reduce lowering leaves them. Overflow
    past ``cap`` is truncated; the caller flags it (``total > cap``)."""
    q, c = counts.shape
    cum = torch.cumsum(counts, dim=-1, dtype=torch.int32)          # [Q, C]
    total = cum[:, -1]
    p = torch.arange(cap, dtype=torch.int32, device=counts.device)
    pq = p[None, :].expand(q, cap).contiguous()
    owner = torch.searchsorted(cum.contiguous(), pq, right=True)   # [Q, cap]
    oc = owner.clamp(max=c - 1)
    excl = torch.gather(cum, 1, oc) - torch.gather(counts, 1, oc)
    entry = torch.where(owner < c, torch.gather(starts, 1, oc) + (pq - excl),
                        pq)
    valid = p[None, :] < total.clamp(max=cap)[:, None]
    return entry, valid, total


# --------------------------------------------------------------------------
# One radius step
# --------------------------------------------------------------------------

def _table_candidates(table: MIHTable, codes: Optional[torch.Tensor],
                      queries: torch.Tensor, q_sub: torch.Tensor,
                      masks: torch.Tensor, done: torch.Tensor, cap: int,
                      use_bitmap: bool):
    """Candidates of one bucket table at one radius: every flipped
    substring is looked up in the directory (gated by the occupancy bitmap
    with ``use_bitmap``), the buckets are expanded into ``cap`` slots, and
    each slot's id and code are gathered (the code from ``entry_codes``,
    else from ``codes`` at the id) and scored. Returns ``(cand_dist [Q,
    cap], cand_id [Q, cap], total, n_probe, n_nonempty)``."""
    probes = q_sub[:, None] ^ masks[None, :]                       # [Q, C]
    starts, counts = table.directory.lookup(probes)
    if use_bitmap and table.bitmap is not None:
        counts = torch.where(table.bitmap.get(probes), counts, 0)
    counts = torch.where(done[:, None], 0, counts)
    n_probe = torch.where(done, 0, probes.shape[1]).to(torch.int32)
    n_nonempty = (counts > 0).sum(dim=-1, dtype=torch.int32)
    entry, valid, total = expand_buckets(starts, counts, cap)
    entry_c = entry.clamp(0, table.entry_ids.shape[0] - 1).long()
    cand_id = table.entry_ids[entry_c]                             # [Q, cap]
    if table.entry_codes is not None:
        cand_codes = table.entry_codes[entry_c]                 # [Q, cap, W]
    else:
        cand_codes = codes[cand_id.clamp(0, codes.shape[0] - 1).long()]
    dist = hamming_distance(cand_codes, queries[:, None, :])
    return (torch.where(valid, dist, topk.INF_DIST),
            torch.where(valid, cand_id, topk.INVALID_ID), total, n_probe,
            n_nonempty)


def _table_candidates_range(table: MIHTable, codes: Optional[torch.Tensor],
                            queries: torch.Tensor, q_sub: torch.Tensor,
                            pmasks: torch.Tensor, done: torch.Tensor,
                            cap: int, s_bits: int, blk: int):
    """Candidates of one range table at one radius: one probe per flipped
    prefix fetches the prefix's whole row range of ``blk`` entries per row,
    from the inline rows, or from the compact id rows and ``codes``.
    Returns ``(cand_dist [Q, S], cand_id [Q, S], n_scored, overflow,
    n_probe, n_nonempty)``, S = the chunk budget in slots."""
    d = table.directory
    compact = table.entry_rows is None
    rows = table.entry_idrows if compact else table.entry_rows
    chb = max(4, cap // blk)
    pref = shr(q_sub, s_bits - d.pbits)[:, None] ^ pmasks[None, :]  # [Q, H]
    starts, counts = d.range_lookup(pref)
    active = ~done
    counts = torch.where(active[:, None], counts, 0)
    n_probe = torch.where(active, pref.shape[1], 0).to(torch.int32)
    n_nonempty = (counts > 0).sum(dim=-1, dtype=torch.int32)
    blk_id, lo, hi, _nch, overflow = chunks_lib.chunk_descriptors(
        starts, counts, blk=blk, chb=chb, n_blocks=rows.shape[0])
    if compact:
        dist, cand_id = chunks_lib.fetch_score_idrows(
            rows, codes, blk_id, lo, hi, queries)
    else:
        dist, cand_id = chunks_lib.fetch_score_blocks(
            rows, blk_id, lo, hi, queries, blk=blk)
    n_scored = (hi - lo).sum(dim=-1, dtype=torch.int32)
    return dist, cand_id, n_scored, overflow, n_probe, n_nonempty


def radius_step(tables, queries: torch.Tensor, q_subs: torch.Tensor,
                masks: torch.Tensor, state: SearchState, *, radius: int,
                n_tables: int, knn: int, cap: int, s_bits: int, blk: int,
                approximate: bool = False, use_bitmap: bool = False,
                codes: Optional[torch.Tensor] = None) -> SearchState:
    """Process one radius group for the whole batch. Exact mode stops a
    query when its kth distance is at most ``(radius + 1) * n_tables``;
    approximate mode when its ``k * factor`` pool is full
    (``search_worker.cc:136-137``); both at ``radius >= s_bits``. Each
    table's candidates are cut to a pool-wide strip as soon as they
    are scored (ids are unique within one table at one step), so only one
    table's candidate slab is alive at a time. Strips are packed
    ``dist << 24 | id`` keys while ids and distances fit them
    (:func:`topk.can_pack`), else explicit ``(dist, id)`` pairs.
    ``blk`` is the tables' entries per row (:meth:`MIHIndex.fetch_block`);
    ``codes`` (the index's id-ordered codes) feed the candidate codes of
    compact range tables and of bucket tables without ``entry_codes``.
    Range tables overflow when a query needs more chunks than the budget,
    bucket tables when its buckets hold more than ``cap`` entries."""
    w = queries.shape[-1]
    p = state.pool_dist.shape[-1]
    max_id = max(t.n_entries(w) for t in tables)
    packed = topk.can_pack(max_id - 1, 32 * w)
    overflow = state.overflow
    total_c = torch.zeros_like(state.n_cands)
    n_probes, n_nonempty = state.n_probes, state.n_nonempty
    is_range = isinstance(tables[0].directory, RangeDirectory)
    strips = []
    for t in range(n_tables):
        if is_range:
            d, i, tot, ovf, npb, nne = _table_candidates_range(
                tables[t], codes, queries, q_subs[:, t], masks, state.done,
                cap, s_bits, blk)
        else:
            d, i, tot, npb, nne = _table_candidates(
                tables[t], codes, queries, q_subs[:, t], masks, state.done,
                cap, use_bitmap)
            ovf = tot > cap
        strips.append(topk.table_topk_chunkmin_packed(d, i, p, blk) if packed
                      else topk.table_topk_chunkmin_pos(d, i, p, blk))
        del d, i
        overflow = overflow | ovf
        total_c = total_c + torch.clamp(tot, max=cap)
        n_probes = n_probes + npb
        n_nonempty = n_nonempty + nne
    if packed:
        pd, pi = topk.merge_strips_packed(state.pool_dist, state.pool_id,
                                          torch.cat(strips, dim=-1),
                                          n_copies=n_tables + 1)
    else:
        sd, si = zip(*strips)
        pd, pi = topk.merge_strips_dedup_pos(
            state.pool_dist, state.pool_id, torch.cat(sd, dim=-1),
            torch.cat(si, dim=-1))
    if approximate:
        newly_done = pi[:, -1] >= 0
    else:
        full, kth = topk.kth_stats(pd, pi, knn)
        newly_done = full & (kth <= (radius + 1) * n_tables)
    newly_done = newly_done | (radius >= s_bits)
    return SearchState(pool_dist=pd, pool_id=pi, done=state.done | newly_done,
                       radius=torch.where(state.done, state.radius, radius),
                       overflow=overflow, n_probes=n_probes,
                       n_nonempty=n_nonempty, n_cands=state.n_cands + total_c)


# --------------------------------------------------------------------------
# Schedules, caps and budgets (same rules as the reference)
# --------------------------------------------------------------------------

def effective_scfg(scfg: SearchConfig) -> SearchConfig:
    """Approximate requests above ``approx_exact_crossover`` pool slots run
    the exact engine (as every reference driver does)."""
    if scfg.approximate and scfg.pool_size > scfg.approx_exact_crossover:
        return dataclasses.replace(scfg, approximate=False)
    return scfg


def _check_query_shape(index: MIHIndex, queries: torch.Tensor) -> None:
    if queries.ndim != 2 or queries.shape[-1] != index.cfg.n_words:
        raise ValueError(
            f"queries shape {tuple(queries.shape)} does not match index "
            f"code width ({index.cfg.n_words} uint32 words = "
            f"{index.cfg.bits} bits); expected [Q, {index.cfg.n_words}]")


def _cap_for_radius(scfg: SearchConfig, n: int, radii, mask_bits: int,
                    blk: int, is_range: bool = True) -> int:
    """Per-radius candidate capacity in slots, from the uniform-occupancy
    expectation; overflow detection and re-runs cover skewed data. Range
    tables: one fetch block per probe, twice the expectation, and room for
    one hot range. Bucket tables: four times the expectation and the pool,
    to a power of two."""
    n_m = sum(enumeration.n_masks(mask_bits, r) for r in radii)
    expected = n_m * (n / float(1 << mask_bits))
    if is_range:
        slots = n_m * blk + 2 * int(expected) + 12 * blk
        cap = -(-slots // (4 * blk)) * (4 * blk)
    else:
        cap = _pow2ceil(int(4 * expected) + 4 * scfg.pool_size + 128)
    return int(min(scfg.candidate_cap, max(256, cap)))


def _radius_schedule(scfg: SearchConfig, cfg: MIHConfig, n: int,
                     mask_bits: int, is_range: bool = True):
    """Coalesced {0, 1} (exact mode) then one radius per stage, cut where
    enumerating costs more than scanning the corpus: for range tables in
    fetched rows, for bucket tables in probes."""
    max_r = min(scfg.max_enum_radius, mask_bits)
    if scfg.coalesce_radii and not scfg.approximate and max_r >= 1:
        schedule = [(1, (0, 1))] + [(r, (r,)) for r in range(2, max_r + 1)]
    else:
        schedule = [(r, (r,)) for r in range(max_r + 1)]
    out = []
    for r, group in schedule:
        n_group = sum(enumeration.n_masks(mask_bits, g) for g in group)
        # fetched rows: ~(expected range + one block) per probe, against
        # scanning all n codes once
        cost = (n_group * (n / float(1 << mask_bits) + RANGE_BLK)
                if is_range else n_group)
        too_dear = cost * cfg.n_tables > scfg.fallback_ratio * max(n, 1)
        if r > 1 and too_dear:
            break
        out.append((r, group))
    return tuple(out)


def _stage_shift(knn: int, n: int = 0) -> int:
    """First-stage batch-budget shift: stage budgets are
    ``nq >> (shift + 2*(stage-1))``; gentler for wide k, and the aggressive
    shrink only where the corpus size says a spilled row's scan is cheap."""
    if knn > 32:
        return 2
    return 5 if 0 < n <= 4_000_000 else 4


# --------------------------------------------------------------------------
# The staged pipeline
# --------------------------------------------------------------------------

def _blend(full: torch.Tensor, sel: torch.Tensor, flag_sel: torch.Tensor,
           new: torch.Tensor) -> torch.Tensor:
    """``full`` with rows ``sel`` replaced by ``new`` where ``flag_sel``."""
    out = full.clone()
    m = flag_sel.reshape((-1,) + (1,) * (new.ndim - 1))
    out[sel] = torch.where(m, new, full[sel])
    return out


def run_pipeline(step_fn, scan_fn, queries: torch.Tensor,
                 q_subs: torch.Tensor, state0: SearchState, *, schedule,
                 caps, batch_caps, knn: int, pool_size: int,
                 retry_caps=None, retry_budget: int = 0,
                 scan_budget: int = 0, scan_dominance: int = 0,
                 overflow_to_scan: bool = False) -> SearchState:
    """Stages with compaction, then the overflow retry ladder, then the
    scan ladder. ``step_fn(i, radius, cap, queries, q_subs, state)`` is one
    radius step; ``scan_fn(queries) -> (dists [B, knn], ids [B, knn])`` the
    exact scan. ``scan_dominance`` > 0 skips every stage after the first
    when at least that many queries are still active after it.
    ``overflow_to_scan`` sends overflowed-but-finished rows to the scan
    ladder with the stragglers (one ladder, not two); the caller then
    passes no retry caps."""
    nq = queries.shape[0]
    dev = queries.device

    def staged(queries_b, q_subs_b, state_b, stage_caps, stage_batch_caps,
               dominance=0):
        full = state_b
        orig = torch.arange(queries_b.shape[0], device=dev)
        cur_q, cur_qs, cur_state = queries_b, q_subs_b, state_b
        dom = False
        for i, (r, _group) in enumerate(schedule):
            skip = bool(cur_state.done.all())
            if i > 0 and dominance:
                skip = skip or dom
            if not skip:
                cur_state = step_fn(i, r, stage_caps[i], cur_q, cur_qs,
                                    cur_state)
                full = SearchState(*(f.index_copy(0, orig, c)
                                     for f, c in zip(full, cur_state)))
            if i == 0 and dominance:
                # decided once, on the full batch, before any compaction
                dom = int((~cur_state.done).sum()) >= dominance
            if i + 1 < len(schedule):
                nb = stage_batch_caps[i + 1]
                if nb < cur_q.shape[0]:
                    # stable: active rows first, each group in row order;
                    # actives past the budget stay undone in `full` and
                    # are resolved by the scan ladder or the fallbacks
                    perm = torch.argsort(cur_state.done.to(torch.int32),
                                         stable=True)
                    sel = perm[:nb]
                    cur_q, cur_qs = cur_q[sel], cur_qs[sel]
                    cur_state = _take(cur_state, sel)
                    orig = orig[sel]
        return full

    full = staged(queries, q_subs, state0, caps, batch_caps,
                  dominance=scan_dominance if scan_budget else 0)

    if retry_caps:
        # re-run overflowed-but-finished rows from radius 0 at the retry
        # caps: a small tier for the usual handful, the full budget only
        # when the small one is outgrown (exclusive gates on one count)
        flag = full.overflow & full.done
        n_f = int(flag.sum())
        perm = torch.argsort((~flag).to(torch.int32), stable=True)
        small = min(retry_budget, max(64, nq // 16))
        budgets = [small] + ([retry_budget] if retry_budget > small else [])
        for bi, budget in enumerate(budgets):
            run = n_f > (0 if bi == 0 else budgets[bi - 1])
            if bi + 1 < len(budgets):
                run = run and n_f <= budget
            if not run:
                continue
            sel = perm[:budget]
            # the reference sizes these without n (its _stage_shift(knn))
            retry_bc = tuple(
                budget if i == 0
                else max(64, budget >> (_stage_shift(knn) + 2 * (i - 1)))
                for i in range(len(schedule)))
            flag_sel = flag[sel]
            rstate = init_state(budget, pool_size, dev)._replace(
                done=~flag_sel)
            rfull = staged(queries[sel], q_subs[sel], rstate, retry_caps,
                           retry_bc)
            # pools and flags from the re-run; the read-amplification
            # stats keep the first run's counts
            full = full._replace(**{
                f: _blend(getattr(full, f), sel, flag_sel, getattr(rfull, f))
                for f in ("pool_dist", "pool_id", "done", "radius",
                          "overflow")})

    if scan_budget and scan_fn is not None:
        # tiered scan of the unfinished rows: exactly the first tier whose
        # budget covers the straggler count runs
        flag = ~full.done
        if overflow_to_scan:
            # the scan is exact, so it supersedes any clipped pool; the
            # blend below marks these rows done and clears their overflow
            flag = flag | full.overflow
        n_sc = int(flag.sum())
        perm = torch.argsort((~flag).to(torch.int32), stable=True)
        budgets = [min(scan_budget, nq)]
        while budgets[-1] < nq:
            budgets.append(min(nq, budgets[-1] * 8))
        for bi, budget in enumerate(budgets):
            run = n_sc > (0 if bi == 0 else budgets[bi - 1])
            if budget < nq:
                run = run and n_sc <= budget
            if not run:
                continue
            sel = perm[:budget]
            flag_sel = flag[sel]
            d, i = scan_fn(queries[sel])
            if pool_size > knn:
                d = torch.nn.functional.pad(d, (0, pool_size - knn),
                                            value=topk.INF_DIST)
                i = torch.nn.functional.pad(i, (0, pool_size - knn),
                                            value=topk.INVALID_ID)
            full = full._replace(
                pool_dist=_blend(full.pool_dist, sel, flag_sel, d),
                pool_id=_blend(full.pool_id, sel, flag_sel, i),
                done=_blend(full.done, sel, flag_sel,
                            torch.ones_like(flag_sel)),
                overflow=_blend(full.overflow, sel, flag_sel,
                                torch.zeros_like(flag_sel)))
    return full


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def _check_bitmap_engine(index: MIHIndex, scfg: SearchConfig) -> None:
    """``use_bitmap`` gates bucket lookups; the range engine reads whole
    prefix ranges, whose (start, end) pair answers occupancy anyway, so a
    bitmap request there raises rather than being ignored."""
    if scfg.use_bitmap and index.is_range:
        raise ValueError(
            "use_bitmap=True has no effect on the range-directory engine "
            "(range fetches subsume the occupancy test); build with "
            "directory='dense' or 'hash' and with_bitmap=True to use the "
            "bitmap filter, or drop use_bitmap")


def _index_mask_bits(index: MIHIndex) -> int:
    """Bits the flip masks run over: a range directory's prefix width
    (probes are per prefix), else the whole substring."""
    d = index.tables[0].directory
    return d.pbits if isinstance(d, RangeDirectory) else index.cfg.s_bits


def _flip_masks(mask_bits: int, group, device) -> torch.Tensor:
    m = np.concatenate([enumeration.flip_masks(mask_bits, g) for g in group])
    return torch.from_numpy(m.view(np.int32)).to(device)


def _prepare(index: MIHIndex, queries, scfg: SearchConfig):
    """The request as every driver takes it: the effective config, the
    queries as a contiguous int32 tensor on the index's device, and the
    radius schedule."""
    scfg = effective_scfg(scfg)
    _check_bitmap_engine(index, scfg)
    queries = as_codes(queries, index.device).contiguous()
    _check_query_shape(index, queries)
    return scfg, queries, _radius_schedule(scfg, index.cfg, index.n,
                                           _index_mask_bits(index),
                                           index.is_range)


def mih_search(index: MIHIndex, queries,
               scfg: SearchConfig = SearchConfig(),
               _cap: Optional[int] = None) -> SearchResult:
    """Batched K-NN over the MIH index, on the index's device.

    ``queries``: ``uint32[Q, W]`` numpy codes or an ``int32[Q, W]`` tensor.
    Runs the fused staged pipeline (:func:`mih_search_dispatch` then
    :func:`mih_search_finalize`), or the loop driver when ``scfg.fused`` is
    off or no radius stage fits ``fused_max_masks``; queries whose
    candidate budgets still overflowed are re-run at 4x caps, and queries
    unfinished at the last stage take the exact linear scan. The result
    lies on the host."""
    h = mih_search_dispatch(index, queries, scfg, _cap)
    if h is not None:
        return mih_search_finalize(h)
    scfg, queries, schedule = _prepare(index, queries, scfg)
    return _mih_search_loop(index, queries, scfg, _cap, schedule)


def _step_fn(index: MIHIndex, scfg: SearchConfig, r: int, cap: int):
    """``radius_step`` at radius ``r`` and candidate cap ``cap``:
    ``(queries, q_subs, masks, state) -> state``."""
    return functools.partial(
        radius_step, tuple(index.tables), radius=r,
        n_tables=index.cfg.n_tables, knn=scfg.knn, cap=cap,
        s_bits=index.cfg.s_bits, blk=index.fetch_block(),
        approximate=scfg.approximate, use_bitmap=scfg.use_bitmap,
        codes=index.codes)


# --------------------------------------------------------------------------
# The fused driver: dispatch, the packed result row, finalize
# --------------------------------------------------------------------------

class FusedHandle(NamedTuple):
    """An in-flight fused search: the packed result row on the index's
    device (see :func:`_pack_row`), its host copy and the CUDA event that
    marks the copy done (on the CPU: the row itself and no event), and
    what finalize needs besides."""

    packed: torch.Tensor     # int32 [Q, k + 3] or [Q, 2k + 3]
    host: torch.Tensor       # the same row on the host (pinned on CUDA)
    event: Optional["torch.cuda.Event"]
    queries: torch.Tensor
    index: MIHIndex
    scfg: SearchConfig
    cap: Optional[int]


def _result_id_bits(tables, bits: int) -> int:
    """Bits of id payload when one 32-bit word holds a result ``(dist,
    id)`` pair, 0 when it cannot (the ``[Q, 2k + 3]`` layout). Sized so
    every true distance 0..bits and an all-ones sentinel fit above."""
    max_id = max(t.n_entries(bits // 32) for t in tables)
    id_bits = max(1, int(max_id - 1).bit_length())
    return id_bits if (1 << (32 - id_bits)) - 1 > bits else 0


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _pack_row(full: SearchState, k: int, id_bits: int) -> torch.Tensor:
    """The reference's packed result row (``fused_pipeline_packed``), as
    int32 bit patterns. With ``id_bits`` > 0: ``[Q, k + 3]`` = the top-k
    pairs as ``dist << id_bits | id`` words (all ones = empty slot), then
    the three stat words; else ``[Q, 2k + 3]`` = the top-k dists, the top-k
    ids, the three stat words. The stat words are ``flags`` = done (bit 0)
    | overflow (bit 1) | covf (bit 2, always 0 on one device) | radius
    saturated at 127 (bits 3-9) | n_probes saturated at 0xFFFF (bits
    16-31), then ``n_nonempty`` and ``n_cands``."""
    flags = (full.done.long() | (full.overflow.long() << 1)
             | (full.radius.clamp(max=127).long() << 3)
             | (full.n_probes.clamp(max=0xFFFF).long() << 16))
    cols = torch.stack([_i32(flags), full.n_nonempty, full.n_cands], dim=1)
    pd, pi = full.pool_dist[:, :k], full.pool_id[:, :k]
    if id_bits:
        pool = torch.where(pi < 0, -1,
                           _i32((pd.long() << id_bits) | pi.long()))
        return torch.cat([pool, cols], dim=1)
    return torch.cat([pd, pi, cols], dim=1)


def _unpack_row(row: torch.Tensor, k: int, id_bits: int) -> dict:
    """Inverse of :func:`_pack_row` on the host: the per-query fields."""
    u = row.long() & 0xFFFFFFFF
    if id_bits:
        pool = u[:, :k]
        empty = pool == 0xFFFFFFFF
        dists = torch.where(empty, topk.INF_DIST, pool >> id_bits)
        ids = torch.where(empty, topk.INVALID_ID, pool & ((1 << id_bits) - 1))
        stats = u[:, k:]
    else:
        dists, ids, stats = row[:, :k], row[:, k:2 * k], u[:, 2 * k:]
    flags = stats[:, 0]
    return dict(dists=dists.to(torch.int32, copy=True),
                ids=ids.to(torch.int32, copy=True),
                not_done=(flags & 1) == 0, overflow=(flags & 2) != 0,
                radius=((flags >> 3) & 0x7F).to(torch.int32),
                n_probes=(flags >> 16).to(torch.int32),
                n_nonempty=stats[:, 1].to(torch.int32),
                n_cands=stats[:, 2].to(torch.int32))


def mih_search_dispatch(index: MIHIndex, queries,
                        scfg: SearchConfig = SearchConfig(),
                        _cap: Optional[int] = None
                        ) -> Optional[FusedHandle]:
    """The fused driver up to the packed result row, on the index's
    device; on CUDA the row's copy into pinned host memory is started and
    an event recorded behind it, and the call returns without waiting for
    the copy. Returns None where the fused driver does not run this
    request (``scfg.fused`` off, or no radius stage under
    ``fused_max_masks``). Pair with :func:`mih_search_finalize`; several
    handles may be in flight and finalized in any order."""
    if not scfg.fused:
        return None
    scfg, queries, schedule = _prepare(index, queries, scfg)
    mask_bits = _index_mask_bits(index)
    schedule = tuple(
        (r, g) for r, g in schedule
        if sum(enumeration.n_masks(mask_bits, x) for x in g)
        <= scfg.fused_max_masks)
    if not schedule:
        return None
    packed = _fused_row(index, queries, scfg, _cap, schedule)
    if packed.is_cuda:
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        with torch.cuda.device(packed.device):
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
    else:
        host, event = packed, None
    return FusedHandle(packed=packed, host=host, event=event,
                       queries=queries, index=index, scfg=scfg, cap=_cap)


def mih_search_finalize(h: FusedHandle) -> SearchResult:
    """Wait for a dispatched search's row to reach the host, decode it and
    apply the fallbacks."""
    if h.event is not None:
        h.event.synchronize()
    row = _unpack_row(h.host, h.scfg.knn,
                      _result_id_bits(h.index.tables, h.index.cfg.bits))
    return _apply_fallbacks(h.index, h.queries, h.scfg, h.cap, h.scfg.knn,
                            **row)


def _fused_row(index: MIHIndex, queries: torch.Tensor, scfg: SearchConfig,
               _cap: Optional[int], schedule) -> torch.Tensor:
    """The whole schedule through :func:`run_pipeline`, as the packed
    result row."""
    cfg = index.cfg
    dev = index.device
    nq = queries.shape[0]
    k, pool_size = scfg.knn, scfg.pool_size
    mask_bits = _index_mask_bits(index)
    scan_budget = min(nq, max(64, nq // 64)) if index.codes is not None else 0
    caps = tuple(_cap or _cap_for_radius(scfg, index.n, g, mask_bits,
                                         index.fetch_block(), index.is_range)
                 for _, g in schedule)
    batch_caps = tuple(
        nq if i == 0 else max(64, nq >> (_stage_shift(k, index.n)
                                         + 2 * (i - 1)))
        for i in range(len(schedule)))
    masks = [_flip_masks(mask_bits, g, dev) for _, g in schedule]
    retry_caps = tuple(min(c * 2, max(scfg.candidate_cap, c)) for c in caps)
    # exact mode only, as the dominance gate: the exact scan would upgrade
    # approximate answers
    overflow_to_scan = (scfg.overflow_to_scan and scan_budget > 0
                        and not scfg.approximate
                        and index.n <= OVERFLOW_SCAN_MAX_N)

    def step_fn(i, r, cap, cq, cqs, cs):
        return _step_fn(index, scfg, r, cap)(cq, cqs, masks[i], cs)

    def scan_fn(sq):
        # smaller blocks at large k: the rescore gathers k blocks per query
        return scan_blockmin(sq, index.codes, k,
                             block=512 if k <= 32 else 128)

    full = run_pipeline(
        step_fn, scan_fn if index.codes is not None else None, queries,
        index.table_subs(queries), init_state(nq, pool_size, dev),
        schedule=schedule, caps=caps, batch_caps=batch_caps, knn=k,
        pool_size=pool_size,
        retry_caps=(None if overflow_to_scan or retry_caps == caps
                    else retry_caps),
        retry_budget=0 if overflow_to_scan else min(nq, max(64, nq // 4)),
        scan_budget=scan_budget,
        scan_dominance=(nq // 2 if scan_budget and not scfg.approximate
                        and nq >= SCAN_DOMINANCE_MIN_NQ else 0),
        overflow_to_scan=overflow_to_scan)
    return _pack_row(full, k, _result_id_bits(index.tables, cfg.bits))


# --------------------------------------------------------------------------
# The loop driver
# --------------------------------------------------------------------------

def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _compact(queries: torch.Tensor, q_subs: torch.Tensor,
             state: SearchState, sel: torch.Tensor, n_act: int):
    """Gather the rows ``sel`` (the active rows, then pad rows that copy
    row 0); pad rows are marked done, so no step changes them."""
    st = _take(state, sel)
    pad = torch.arange(sel.shape[0], device=sel.device) >= n_act
    return queries[sel], q_subs[sel], st._replace(done=st.done | pad)


def _retire(final: SearchState, orig: torch.Tensor, state: SearchState,
            rows: torch.Tensor) -> SearchState:
    """``final`` with the original rows ``orig[rows]`` taken from ``state``
    (``rows`` a boolean mask over the current batch); pad rows
    (``orig < 0``) are skipped."""
    rows = rows & (orig >= 0)
    dst = orig[rows]
    return SearchState(*(f.index_copy(0, dst, c[rows])
                         for f, c in zip(final, state)))


def _mih_search_loop(index: MIHIndex, queries: torch.Tensor,
                     scfg: SearchConfig, _cap: Optional[int],
                     schedule) -> SearchResult:
    """The loop driver (the reference's ``fused=False`` path,
    ``single.py:1091-1174``): every stage of the schedule runs on the
    whole current batch, and the host reads the done flags after it (the
    reference's per-radius barrier). Once the active rows fit in half the
    batch, finished rows retire and the rest compact into a power-of-two
    batch of at least 64 rows. A stage whose probe tensor would pass
    2^26 elements runs in query slices."""
    cfg = index.cfg
    dev = index.device
    nq = queries.shape[0]
    k, pool_size = scfg.knn, scfg.pool_size
    mask_bits = _index_mask_bits(index)
    cur_q, cur_qs = queries, index.table_subs(queries)
    state = init_state(nq, pool_size, dev)
    final = init_state(nq, pool_size, dev)   # retired rows, original order
    orig = torch.arange(nq, device=dev)      # batch row -> original row
    for r, group in schedule:
        cap = _cap or _cap_for_radius(scfg, index.n, group, mask_bits,
                                      index.fetch_block(), index.is_range)
        masks = _flip_masks(mask_bits, group, dev)
        step = _step_fn(index, scfg, r, cap)
        b = cur_q.shape[0]
        if b * masks.shape[0] > (1 << 26) and b > 64:
            sl = max(64, _pow2ceil((1 << 26) // max(masks.shape[0], 1)) // 2)
            parts = [step(cur_q[lo:lo + sl], cur_qs[lo:lo + sl], masks,
                          SearchState(*(leaf[lo:lo + sl] for leaf in state)))
                     for lo in range(0, b, sl)]
            state = SearchState(*(torch.cat(leaves)
                                  for leaves in zip(*parts)))
        else:
            state = step(cur_q, cur_qs, masks, state)
        n_active = int((~state.done).sum())
        if n_active == 0:
            break
        new_batch = max(_pow2ceil(n_active), 64)
        if new_batch <= b // 2:
            final = _retire(final, orig, state, state.done)
            act = torch.nonzero(~state.done).flatten()
            sel = torch.cat([act, act.new_zeros(new_batch - n_active)])
            cur_q, cur_qs, state = _compact(cur_q, cur_qs, state, sel,
                                            n_active)
            orig = torch.cat([orig[act],
                              orig.new_full((new_batch - n_active,), -1)])
    final = SearchState(*(f.cpu() for f in _retire(
        final, orig, state, torch.ones_like(state.done))))
    return _apply_fallbacks(
        index, queries, scfg, _cap, k,
        dists=final.pool_dist[:, :k].clone(),
        ids=final.pool_id[:, :k].clone(), radius=final.radius,
        overflow=final.overflow, not_done=~final.done,
        n_probes=final.n_probes, n_nonempty=final.n_nonempty,
        n_cands=final.n_cands)


def _apply_fallbacks(index: MIHIndex, queries: torch.Tensor,
                     scfg: SearchConfig, _cap: Optional[int], k: int, *,
                     dists, ids, radius, overflow, not_done, n_probes,
                     n_nonempty, n_cands) -> SearchResult:
    """Overflow retry at 4x caps, then the exact linear scan for queries
    still unfinished (or overflowed at a cap that already covers n). The
    per-query fields are host tensors, and the result stays on the host;
    ``queries`` lies on the index's device."""
    dev = queries.device
    redo = overflow & ~not_done
    base_cap = _cap or scfg.candidate_cap
    if bool(redo.any()):
        if base_cap < index.n:
            idxs = torch.nonzero(redo).flatten()
            new_cap = min(base_cap * 4, max(index.n, 8))
            # bound the retry's candidate slots (~0.5 GB of int32 pairs)
            max_rows = max(64, (1 << 25) // max(new_cap, 1))
            for lo in range(0, idxs.shape[0], max_rows):
                part = idxs[lo:lo + max_rows]
                sub = mih_search(index, queries[part.to(dev)], scfg,
                                 _cap=new_cap)
                dists[part] = sub.dists
                ids[part] = sub.ids
                radius[part] = sub.radius
        else:
            # range budgets are consumed in whole blocks, so cap >= n does
            # not prove completeness: never drop a set overflow flag
            not_done = not_done | redo
    if bool(not_done.any()):
        if index.codes is None:
            raise ValueError(
                "queries unfinished at max_enum_radius and index has no "
                "code array for linear fallback; raise max_enum_radius")
        idxs = torch.nonzero(not_done).flatten()
        ld, li = linear_lib.linear_search(queries[idxs.to(dev)], index.codes,
                                          k)
        dists[idxs] = ld.cpu()
        ids[idxs] = li.cpu()
    return SearchResult(dists=dists, ids=ids, radius=radius,
                        n_probes=n_probes, n_nonempty=n_nonempty,
                        n_cands=n_cands)
