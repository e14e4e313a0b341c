"""Multi-device MIH search over a (table, shard, query) mesh, SPMD on
``torch.distributed``.

Port of ``verticut_tpu/search/sharded.py``. The reference's distributed
path — one MPI rank per substring table probing its own table, a
per-radius ``MPI_Gatherv`` of candidates to the master, dedup and a
bounded heap there, the stop flag broadcast back
(``src/search_worker.cc:159-218``, ``src/mpi_coordinator.cc:34-69``) — runs
here as one process per mesh device, each holding only its own slices:

* table ``t``'s substring-sorted entry-row blocks live on the ranks of
  ``table=t``, range-partitioned over ``shard`` (contiguous slices, so a
  probed prefix range meets each shard in one clamp; a bucket that
  straddles a boundary is returned piecewise and merged downstream);
* the table's range directory (global row coordinates) is replicated over
  ``shard``: each rank clamps the probed ranges to its own row slice;
* the query batch is split over ``query``; every rank is given the whole
  batch and takes its slice;
* per radius every rank probes and fetches locally, pre-merges its
  tables' strips, all-gathers them over its (table, shard) plane and runs
  the same dedup merge as every other rank of the plane: no master rank,
  the stop predicate is computed on every rank, the ``bcast`` disappears.

The reference runs the per-device body under ``shard_map``, where XLA
makes every branch static. The port runs it eagerly, and the pipeline
(:func:`search.single.run_pipeline`) branches on scalars it reads from the
device. So every rank of a (table, shard) plane must take the same
branches and issue the same collectives in the same order. The invariants
that make it so:

* the merged pool is replicated bit for bit across each (table, shard)
  plane: every rank merges the same gathered operands, in the same order,
  with selection keys unique per id, and the stats and overflow flags are
  summed over the plane. Every gate of ``run_pipeline`` (stage skip, scan
  dominance, compaction, retry and scan tiers) reads only that state, so
  it takes the same branch on every rank of the plane;
* no collective inside the pipeline spans the query axis, whose planes
  hold other queries and diverge there. The results all-gather over the
  query axis once, at the end, so every rank returns the whole
  :class:`SearchResult`; the host retry and the linear fallback then
  decide alike on every rank and stay in lockstep.

The radius step keeps the reference's two selections: packed
``dist << 24 | id`` strips while the ids fit them, else explicit
``(dist, id)`` strips merged by ``merge_strips_dedup_pos``. The
reference's ``_pos`` selections break distance ties by candidate slot,
the port's by id (ROADMAP.md Queue 3), so on that branch ids at a tied
kth distance may differ from the reference's; dists and stats do not.

Two drivers share the step, as in the reference: the fused pipeline
(``scfg.fused``, the default) and the per-radius loop (``fused=False``).
The scan tier and the linear fallback are :func:`_device_linear`: each
rank runs the block-min scan (``linear_search(method="blockmin")``, the
blockmin kernel on a GPU) over the real rows of its slice only. The
reference scans the whole slice with ``scan_popcount`` and masks the
padding rows after its top k, so a zero pad near the query can take a
real row's slot (ROADMAP.md Queue 3); the port never makes a pad a
candidate. Where the reference's fallback scans the whole batch and keeps
the unfinished rows, the port scans only those rows (padded to the query
axis): the scan is exact per row, so the answers are the same.

Spans (:func:`~verticut_tpu_torch.utils.timer.span`), for both engines:
``mih.sharded.step`` around each radius step (``mih.fetch_score`` a table
inside the inline one), ``mih.sharded.scan`` around the scan tier and the
fallback, ``mih.sharded.gather_result`` around the results' gather; the
collectives add their own (:mod:`verticut_tpu_torch.parallel.collectives`).
Counters: ``mih.sharded_batches`` and ``mih.sharded_queries`` for each
client batch (:func:`count_batch`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from verticut_tpu_torch.bits import as_codes, shr
from verticut_tpu_torch.codes import all_substrings
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index import directory as dir_lib
from verticut_tpu_torch.index.mih import (entry_block_size, entry_row_align,
                                          make_entry_rows, sort_table)
from verticut_tpu_torch.ops import chunks as chunks_lib
from verticut_tpu_torch.ops import topk
from verticut_tpu_torch.parallel import collectives
from verticut_tpu_torch.parallel.mesh import Mesh
from verticut_tpu_torch.search.linear import linear_search
from verticut_tpu_torch.search.single import (
    SearchResult, SearchState, apply_fallbacks, check_query_shape,
    effective_scfg, init_state, range_stages, run_pipeline, tier_plan)
from verticut_tpu_torch.utils.timer import count, span


@dataclasses.dataclass
class ShardedMIHIndex:
    """One rank's slices of the sharded index.

    ``entry_rows [tl, NB/S, blk*rw]``: the blocked word-major ``(id,
    code)`` rows (see ``index.mih.MIHTable.entry_rows``) of this rank's
    tables (one, or all ``m`` when the table axis is folded), rows of its
    shard; ``se [tl, 2^pbits, 2]``: those tables' range directories, in
    global row coordinates; ``codes [n_rows / (T*S), W]``: this rank's
    slice of the id-ordered padded codes (the scan tier and the
    fallback)."""

    cfg: MIHConfig
    mesh: Mesh
    n: int
    n_rows: int                 # padded per-table row count (Ntot)
    entry_rows: torch.Tensor    # int32[tl, NB/S, blk*rw]
    se: torch.Tensor            # int32[tl, 2^pbits, 2]
    codes: torch.Tensor         # int32[Ntot / (T*S), W]

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["shard"]

    @property
    def pbits(self) -> int:
        return (self.se.shape[1]).bit_length() - 1

    @property
    def device(self) -> torch.device:
        return self.codes.device


def _check_member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError("this rank lies outside the mesh")


def mesh_tables(mesh: Mesh, cfg: MIHConfig) -> int:
    """Tables per rank along the mesh's table axis (1, or m when folded);
    the reference's ``_mesh_tl``."""
    if mesh.shape["table"] not in (1, cfg.n_tables):
        raise ValueError(
            f"mesh table axis {mesh.shape['table']} != n_tables "
            f"{cfg.n_tables} (or 1)")
    return cfg.n_tables // mesh.shape["table"]


def _my_tables(mesh: Mesh, cfg: MIHConfig):
    """The global table numbers this rank holds."""
    tl = mesh_tables(mesh, cfg)
    return [mesh.coords[0] * tl + tt for tt in range(tl)]


def build_sharded_index(codes_arr, cfg: MIHConfig, mesh: Mesh,
                        pbits: Optional[int] = None) -> ShardedMIHIndex:
    """Build this rank's slices; every rank of the mesh calls it with the
    whole corpus (numpy codes or a tensor). The per-table sort is the
    single-device build's (``index.mih``); distribution is layout only:
    contiguous row ranges of each sorted table go to the ``shard`` axis.
    Padded entries carry substring key 0xFFFFFFFF (they sort last) and id
    -1, which every consumer treats as invalid.

    Besides the corpus, the build holds one table's sort at a time, and
    makes only this rank's rows, in place, and its slice of the codes: no
    padded copy of the corpus or of a table (at 1B codes and one table a
    rank, a peak of the corpus and one sort's transients)."""
    mesh_tables(mesh, cfg)
    _check_member(mesh)
    codes = as_codes(codes_arr, mesh.device).contiguous()
    n, w = codes.shape
    if w != cfg.n_words:
        raise ValueError(f"codes have {w} words, config wants {cfg.n_words}")
    blk = entry_block_size(w)
    n_shards = mesh.shape["shard"]
    # every shard slice must hold whole blocks
    unit = n_shards * entry_row_align(w)
    n_tot = -(-max(n, 1) // unit) * unit
    pbits = pbits or dir_lib.pick_range_pbits(n, cfg.s_bits, blk)
    tables = _my_tables(mesh, cfg)
    nb_loc = n_tot // blk // n_shards
    entry_rows, se_t = None, []
    for tt, t in enumerate(tables):
        sorted_subs, sorted_ids = sort_table(codes, t, cfg.s_bits)
        se = dir_lib.build_range(sorted_subs, cfg.s_bits, pbits=pbits).se
        del sorted_subs
        # the pads' keys are the largest and their positions the last, so
        # the padded sort is the real entries' stable sort, then the pads:
        # in the last prefix's range where a substring is a whole word,
        # past every range where it is narrower
        if cfg.s_bits == 32:
            se[-1, 1] = n_tot
        se_t.append(se)
        if entry_rows is None:
            # after the first sort: its transients and the rows are the
            # two peaks of the build, and they need not meet
            entry_rows = torch.empty((len(tables), nb_loc, blk * (1 + w)),
                                     dtype=torch.int32, device=codes.device)
        make_entry_rows(sorted_ids, codes, out=entry_rows[tt],
                        start=mesh.coords[1] * nb_loc * blk)
        del sorted_ids
    n_loc = n_tot // mesh.n_model
    c0 = min(mesh.model_index * n_loc, n)
    real = codes[c0:min(c0 + n_loc, n)]
    return ShardedMIHIndex(
        cfg=cfg, mesh=mesh, n=n, n_rows=n_tot, entry_rows=entry_rows,
        se=torch.stack(se_t),
        codes=torch.cat([real, real.new_zeros((n_loc - real.shape[0], w))]))


# --------------------------------------------------------------------------
# The radius step (range engine, shard-local clamp)
# --------------------------------------------------------------------------

def _stop(pd, pi, state: SearchState, *, radius, knn, n_tables, s_bits,
          approximate):
    """The stop rule on the merged pool: ``(done, radius)``."""
    if approximate:
        newly_done = pi[:, -1] >= 0
    else:
        full, kth = topk.kth_stats(pd, pi, knn)
        newly_done = full & (kth <= (radius + 1) * n_tables)
    newly_done = newly_done | (radius >= s_bits)
    return (state.done | newly_done,
            torch.where(state.done, state.radius, radius))


def _reduce_stats(state: SearchState, group, overflow_l, n_probe,
                  n_nonempty, n_cands) -> dict:
    """The plane's overflow flags and stat counts, summed in one
    collective, added to ``state``'s."""
    tot = collectives.reduce_sum(torch.stack(
        [overflow_l.to(torch.int32), n_probe, n_nonempty, n_cands]), group)
    return dict(overflow=state.overflow | (tot[0] > 0),
                n_probes=state.n_probes + tot[1],
                n_nonempty=state.n_nonempty + tot[2],
                n_cands=state.n_cands + tot[3])


def sharded_radius_step(mesh: Mesh, entry_rows, se, queries, q_subs, masks,
                        state: SearchState, *, radius: int, n_tables: int,
                        knn: int, cap: int, approximate: bool, s_bits: int,
                        pbits: int, n_rows: int, n_total: int
                        ) -> SearchState:
    """One radius step on this rank's slices (the reference's
    ``_device_radius_step``): ``entry_rows [tl, NBl, blk*rw]``, ``se [tl,
    2^p, 2]`` (global row coordinates), ``queries [Ql, W]``, ``q_subs [Ql,
    m]``, state leaves ``[Ql, ...]``. Returns the plane's merged state,
    the same on every rank of it."""
    t0, s0, _ = mesh.coords
    n_shards = mesh.shape["shard"]
    tl, nbl = entry_rows.shape[0], entry_rows.shape[1]
    blk = entry_block_size(queries.shape[-1])
    n_loc = n_rows // n_shards
    row0 = s0 * n_loc
    chb = max(4, cap // blk)
    shift = s_bits - pbits
    active = ~state.done
    p = state.pool_dist.shape[-1]
    packed = topk.can_pack(n_total - 1, queries.shape[-1] * 32)

    strips = []
    n_probe = torch.zeros_like(state.n_probes)
    n_nonempty = torch.zeros_like(state.n_nonempty)
    total_c = torch.zeros_like(state.n_cands)
    overflow_l = torch.zeros_like(state.done)
    for tt in range(tl):
        tglob = t0 * tl + tt if mesh.shape["table"] > 1 else tt
        pref = shr(q_subs[:, tglob], shift)[:, None] ^ masks[None, :]
        rng = se[tt][pref.long()]
        # clamp the global range to this shard's contiguous row slice —
        # the piecewise bucket return (Pilaf/dht.h:618-620 key split)
        ls = (rng[..., 0] - row0).clamp(0, n_loc)
        le = (rng[..., 1] - row0).clamp(0, n_loc)
        counts = torch.where(active[:, None], le - ls, 0)
        # stats are per (query, table): count them on shard 0 only
        if s0 == 0:
            n_probe += torch.where(active, pref.shape[1], 0).to(torch.int32)
            n_nonempty += (counts > 0).sum(dim=-1, dtype=torch.int32)
        blk_id, lo, hi, _nch, ovf = chunks_lib.chunk_descriptors(
            ls, counts, blk=blk, chb=chb, n_blocks=nbl)
        with span("mih.fetch_score"):
            d, i = chunks_lib.fetch_score_blocks(entry_rows[tt], blk_id, lo,
                                                 hi, queries, blk=blk)
        total_c += (hi - lo).sum(dim=-1, dtype=torch.int32)
        overflow_l |= ovf
        # per-table pre-merge before the collective: ids are unique within
        # one (table, shard) slice at one radius, so local top-P strips
        # keep every global winner
        strips.append(topk.table_topk_chunkmin_packed(d, i, p, blk) if packed
                      else topk.table_topk_chunkmin_pos(d, i, p, blk))
        del d, i

    group = mesh.model_group
    if packed:
        g = collectives.gather_strips(torch.cat(strips, dim=-1), group)
        pd, pi = topk.merge_strips_packed(state.pool_dist, state.pool_id, g,
                                          n_copies=n_tables + 1)
    else:
        sd, si = zip(*strips)
        gd, gi = collectives.gather_candidates(torch.cat(sd, dim=-1),
                                               torch.cat(si, dim=-1), group)
        pd, pi = topk.merge_strips_dedup_pos(state.pool_dist, state.pool_id,
                                             gd, gi)
    done, rad = _stop(pd, pi, state, radius=radius, knn=knn,
                      n_tables=n_tables, s_bits=s_bits,
                      approximate=approximate)
    return SearchState(pool_dist=pd, pool_id=pi, done=done, radius=rad,
                       **_reduce_stats(state, group, overflow_l, n_probe,
                                       n_nonempty, total_c))


# --------------------------------------------------------------------------
# Sharded brute-force scan (the scan tier, the fallback, the oracle)
# --------------------------------------------------------------------------

def _device_linear(mesh: Mesh, codes_loc, queries, k: int, n_loc: int,
                   n_total: int):
    """Exact top-k of ``queries`` over the plane's row slices: each rank
    runs the block-min scan over the real rows of its slice (ids below
    ``n_total``; a rank with fewer than k hands in INF / -1 for the rest,
    one with none launches nothing), the per-rank top-k all-gather over
    the plane and the ``(dist, id)`` smallest k of them are kept, the same
    on every rank of the plane."""
    base = mesh.model_index * n_loc
    r = min(max(n_total - base, 0), n_loc)
    with span("mih.sharded.scan"):
        d, i = linear_search(queries, codes_loc[:r], k, method="blockmin")
        gd, gi = collectives.gather_candidates(
            d, torch.where(i >= 0, i + base, -1), mesh.model_group)
        return topk.table_topk_pos(gd, gi, k)


def _local_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a batch split over the query axis."""
    nq_ax = mesh.shape["query"]
    if x.shape[0] % nq_ax:
        raise ValueError(f"query batch {x.shape[0]} not divisible by query "
                         f"axis {nq_ax}")
    nl = x.shape[0] // nq_ax
    q = mesh.coords[2]
    return x[q * nl:(q + 1) * nl]


def sharded_linear_search(mesh: Mesh, codes_loc, queries, k: int,
                          n_total: Optional[int] = None):
    """Exact top-k ``(dists, ids)`` of the whole batch ``queries`` over the
    row-sharded codes (``codes_loc``: this rank's slice); every rank of the
    mesh calls it with the same queries and gets every row's answer."""
    _check_member(mesh)
    queries = as_codes(queries, mesh.device).contiguous()
    n_loc = codes_loc.shape[0]
    d, i = _device_linear(mesh, codes_loc, _local_rows(mesh, queries), k,
                          n_loc, n_total or n_loc * mesh.n_model)
    g = collectives.gather_rows(torch.cat([d, i], dim=1), mesh.query_group)
    return g[:, :k], g[:, k:]


def lookup_codes(index, ids) -> torch.Tensor:
    """Codes of corpus ids (``int64[r]``, each below ``index.n``) on every
    rank of the mesh: each rank fills the rows of its slice of the
    id-ordered codes and one sum over the plane adds them (every id has
    one owner, the other ranks add zeros). For either sharded index."""
    mesh = index.mesh
    _check_member(mesh)
    ids = torch.as_tensor(ids, dtype=torch.int64).to(mesh.device)
    n_loc = index.codes.shape[0]
    loc = ids - mesh.model_index * n_loc
    own = (loc >= 0) & (loc < n_loc)
    rows = index.codes[loc.clamp(0, n_loc - 1)]
    rows = torch.where(own[:, None], rows, 0)
    return collectives.reduce_sum(rows, mesh.model_group)


# --------------------------------------------------------------------------
# Drivers
# --------------------------------------------------------------------------

def run_fused(step_fn, scan_fn, queries, q_subs, scfg: SearchConfig, *,
              schedule, caps, n: int) -> SearchState:
    """:func:`run_pipeline` over this rank's query slice, with the scan
    tier and the :func:`~verticut_tpu_torch.search.single.tier_plan` at
    the slice's query count (shared by both sharded engines)."""
    nq = queries.shape[0]
    return run_pipeline(
        step_fn, scan_fn, queries, q_subs,
        init_state(nq, scfg.pool_size, queries.device),
        schedule=schedule, caps=caps, knn=scfg.knn,
        pool_size=scfg.pool_size,
        **tier_plan(scfg, n, nq, schedule, caps, scan=True))


def _step(index: ShardedMIHIndex, scfg: SearchConfig, q, qs, masks, state,
          r: int, cap: int) -> SearchState:
    cfg = index.cfg
    with span("mih.sharded.step"):
        return sharded_radius_step(
            index.mesh, index.entry_rows, index.se, q, qs, masks, state,
            radius=r, n_tables=cfg.n_tables, knn=scfg.knn, cap=cap,
            approximate=scfg.approximate, s_bits=cfg.s_bits,
            pbits=index.pbits, n_rows=index.n_rows, n_total=index.n)


def _sharded_fused(index: ShardedMIHIndex, q_loc, scfg: SearchConfig,
                   cap: Optional[int]) -> Optional[SearchState]:
    """The whole schedule, retry and scan tiers through ``run_pipeline``
    on this rank's query slice; None when no stage fits."""
    schedule, masks, caps = range_stages(
        scfg, index.cfg, index.n, index.pbits,
        entry_block_size(index.cfg.n_words), index.device, cap=cap,
        fused=True)
    if not schedule:
        return None
    n_loc = index.codes.shape[0]

    def step_fn(i, r, c, cq, cqs, cs):
        return _step(index, scfg, cq, cqs, masks[i], cs, r, c)

    def scan_fn(sq):
        return _device_linear(index.mesh, index.codes, sq, scfg.knn, n_loc,
                              index.n)

    return run_fused(step_fn, scan_fn, q_loc,
                     all_substrings(q_loc, index.cfg.n_tables), scfg,
                     schedule=schedule, caps=caps, n=index.n)


def _sharded_loop(index: ShardedMIHIndex, q_loc, scfg: SearchConfig,
                  cap: Optional[int]) -> SearchState:
    """The per-radius loop (``fused=False``) over this rank's query slice:
    every stage runs on the whole slice until all of it is done. The plane
    stops together, since ``done`` is replicated across it; another plane
    may stop at another radius, where the reference stops every plane at
    once — a finished row is left as it is by every later step, so the
    answers are the same."""
    cfg = index.cfg
    dev = index.device
    schedule, stage_masks, caps = range_stages(
        scfg, cfg, index.n, index.pbits, entry_block_size(cfg.n_words), dev,
        cap=cap)
    q_subs = all_substrings(q_loc, cfg.n_tables)
    state = init_state(q_loc.shape[0], scfg.pool_size, dev)
    for (r, _group), masks, c in zip(schedule, stage_masks, caps):
        state = _step(index, scfg, q_loc, q_subs, masks, state, r, c)
        if bool(state.done.all()):
            break
    return state


def gather_result(mesh: Mesh, state: SearchState, k: int) -> dict:
    """Every query slice's final state, all-gathered over the query axis
    into one host row per query of the batch: the per-query fields of
    :func:`search.single.apply_fallbacks`."""
    with span("mih.sharded.gather_result"):
        cols = torch.stack([state.radius, state.overflow.to(torch.int32),
                            (~state.done).to(torch.int32), state.n_probes,
                            state.n_nonempty, state.n_cands], dim=1)
        g = collectives.gather_rows(
            torch.cat([state.pool_dist[:, :k], state.pool_id[:, :k], cols],
                      1), mesh.query_group).cpu()
    c = g[:, 2 * k:]
    return dict(dists=g[:, :k].clone(), ids=g[:, k:2 * k].clone(),
                radius=c[:, 0].clone(), overflow=c[:, 1] != 0,
                not_done=c[:, 2] != 0, n_probes=c[:, 3].clone(),
                n_nonempty=c[:, 4].clone(), n_cands=c[:, 5].clone())


def _fallbacks(index, queries, scfg: SearchConfig, cap: Optional[int],
               search, row: dict) -> SearchResult:
    """:func:`~verticut_tpu_torch.search.single.apply_fallbacks`, the same
    on every rank: a re-run subset padded to the query axis through
    ``search`` (the engine's own entry point), the scan the exact sharded
    one (:func:`sharded_linear_search`)."""
    nq_ax = index.mesh.shape["query"]

    def padded(idxs):
        n_pad = (-idxs.shape[0]) % nq_ax
        return queries[torch.cat([idxs, idxs[:1].repeat(n_pad)])
                       .to(queries.device)]

    def rerun(idxs, c):
        m = idxs.shape[0]
        sub = search(index, padded(idxs), scfg, _cap=c)
        return sub.dists[:m], sub.ids[:m], sub.radius[:m]

    def scan(idxs):
        m = idxs.shape[0]
        ld, li = sharded_linear_search(index.mesh, index.codes, padded(idxs),
                                       scfg.knn, n_total=index.n)
        return ld[:m].cpu(), li[:m].cpu()

    return apply_fallbacks(rerun, scan, n=index.n,
                           base_cap=cap or scfg.candidate_cap, **row)


def count_batch(queries, cap: Optional[int]) -> None:
    """Count a client's batch (``cap`` None; the host retry's re-run
    passes its raised cap and adds none): ``mih.sharded_batches`` and
    ``mih.sharded_queries``."""
    if cap is None:
        count("mih.sharded_batches")
        count("mih.sharded_queries", queries.shape[0])


def prepare_queries(index, queries) -> torch.Tensor:
    """The batch as an int32 tensor on the rank's device, checked against
    the code width and the query axis."""
    _check_member(index.mesh)
    queries = as_codes(queries, index.mesh.device).contiguous()
    check_query_shape(index, queries)
    _local_rows(index.mesh, queries)
    return queries


def sharded_mih_search(index: ShardedMIHIndex, queries,
                       scfg: SearchConfig = SearchConfig(),
                       _cap: Optional[int] = None) -> SearchResult:
    """Distributed batched K-NN; every rank of the mesh calls it with the
    same batch and returns the whole result on the host. Same contract as
    :func:`search.single.mih_search`, except that the stats are not
    saturated (the reference's sharded result carries them whole)."""
    scfg = effective_scfg(scfg)
    queries = prepare_queries(index, queries)
    count_batch(queries, _cap)
    q_loc = _local_rows(index.mesh, queries)
    state = _sharded_fused(index, q_loc, scfg, _cap) if scfg.fused else None
    if state is None:
        state = _sharded_loop(index, q_loc, scfg, _cap)
    return _fallbacks(index, queries, scfg, _cap, sharded_mih_search,
                      gather_result(index.mesh, state, scfg.knn))
