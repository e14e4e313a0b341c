"""Compact (ids-only) sharded MIH — the 1B-scale layout and its
distributed build, SPMD on ``torch.distributed``.

Port of ``verticut_tpu/search/sharded_compact.py``. The inline sharded
index (:mod:`search.sharded`) keeps 32 B ``(id, code)`` rows per table and
is built from the whole corpus on every rank; this module is the scale
path:

* **Layout**: per-table blocked id rows (4 B per entry and table) and ONE
  id-sharded code array (16 B per code), ~32 B per code in all.
* **Value-partitioned shards**: shard ``s`` of a table owns the prefix
  values ``[s 2^p / S, (s+1) 2^p / S)`` — the storage servers' key split
  (``Pilaf/dht.h:618-620``) made contiguous in value space — so a probed
  prefix lives wholly in one shard, whose directory holds local row
  coordinates.
* **Per-rank build**: no rank holds a whole table. Each rank holds its id
  slice of the codes; the ranks of a (table, shard) plane stream the
  corpus in chunks through ``all_gather``, each keeps the rows of its
  prefix range (appended at a running offset), then sorts its slice and
  derives its directory — the reference's per-rank streaming build
  (``src/build_hash_tables.cc:25-73``) with the key-value append replaced
  by a filter and one local sort.
* **Distance at the owner**: the finders fetch candidate ids only; the ids
  all-gather over the plane; each rank scores the ids whose codes it
  owns, pre-merges per-table strips, and the strips all-gather back for
  the replicated dedup merge. No code crosses between ranks; the two
  collectives per radius are the ``MPI_Gatherv`` analog split into an id
  leg and a strip leg.

The SPMD invariants of :mod:`search.sharded` hold here too: the merged
pool, the flags and the stats are replicated across each (table, shard)
plane, and only the final result gathers over the query axis. Strips are
selected on ``(dist, id)`` keys, where the reference selects on
``(dist, slot)`` keys (ROADMAP.md Queue 3): a strip of ``P`` cut at a
distance tie still holds ``P`` ids at or below it, so the merged pool's
distances, and with them the stop rule and the stats, are the
reference's; the ids at a tied distance may differ.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from verticut_tpu_torch.bits import as_codes, shr
from verticut_tpu_torch.codes import all_substrings, hamming_distance
from verticut_tpu_torch.codes import substring
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index import directory as dir_lib
from verticut_tpu_torch.index.mih import ID_ROW_BLOCK
from verticut_tpu_torch.ops import chunks as chunks_lib
from verticut_tpu_torch.ops import topk
from verticut_tpu_torch.parallel import collectives
from verticut_tpu_torch.parallel.mesh import Mesh
from verticut_tpu_torch.search.sharded import (
    _check_member, _device_linear, _fallbacks, _local_rows, _my_tables,
    _reduce_stats, _stop, count_batch, gather_result, mesh_tables,
    prepare_queries, run_fused, sharded_linear_search)
from verticut_tpu_torch.search.single import (SearchResult, SearchState,
                                              effective_scfg, range_stages)
from verticut_tpu_torch.utils.timer import span

#: rows of a rank's code slice streamed per all_gather of the build
BUILD_CHUNK = 1 << 20
_PAD_ID = 0x7FFFFFFF


@dataclasses.dataclass
class ShardedCompactIndex:
    """One rank's slices of the compact sharded index.

    ``idrows [tl, cap_rows / 32, 32]``: blocked id-only rows of this
    rank's tables, its value range's rows substring-sorted, padded with id
    -1 (0xFFFFFFFF) to ``cap_rows``; ``se [tl, 2^p / S, 2]``: the range
    directory of its prefix slice, in local row coordinates; ``codes
    [Ntot / (T*S), W]``: its slice of the id-ordered padded codes — the
    ownership axis of the scoring and the scan."""

    cfg: MIHConfig
    mesh: Mesh
    n: int
    pbits: int
    cap_rows: int               # per-(table, shard) row capacity (padded)
    idrows: torch.Tensor        # int32[tl, cap_rows / 32, 32]
    se: torch.Tensor            # int32[tl, 2^pbits / S, 2]
    codes: torch.Tensor         # int32[Ntot / (T*S), W]

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["shard"]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def memory_stats(self) -> dict:
        """Per-device and per-code memory of the whole index (every rank
        of a plane holds an equal share; query-axis ranks replicate it),
        as the reference accounts it."""
        d = self.mesh.n_model
        idrow_b = self.idrows.numel() * 4 * d
        se_b = self.se.numel() * 4 * d
        code_b = self.codes.numel() * 4 * d
        total = idrow_b + se_b + code_b
        return {
            "n": self.n,
            "idrows_bytes": idrow_b,
            "directory_bytes": se_b,
            "codes_bytes": code_b,
            "total_bytes": total,
            "bytes_per_code": total / max(self.n, 1),
            "bytes_per_device": total / d,
            "n_devices": d,
        }


def _local_codes(codes_arr, n: int, n_loc: int, dev: int, device
                 ) -> torch.Tensor:
    """This rank's id slice ``[dev*n_loc, (dev+1)*n_loc)`` of the corpus,
    zero-padded past ``n``."""
    lo, hi = min(dev * n_loc, n), min((dev + 1) * n_loc, n)
    part = codes_arr[lo:hi]
    part = as_codes(part if isinstance(part, torch.Tensor)
                    else np.asarray(part, np.uint32), device)
    if hi - lo == n_loc:
        return part.contiguous()
    out = torch.zeros((n_loc, part.shape[1]), dtype=torch.int32,
                      device=device)
    out[:hi - lo] = part
    return out


def build_sharded_compact(codes_arr, cfg: MIHConfig, mesh: Mesh,
                          pbits: Optional[int] = None,
                          slack: float = 1.5) -> ShardedCompactIndex:
    """Distributed build: every (table, shard) slice is filtered, sorted
    and indexed on its own rank. Every rank of the mesh calls it with the
    corpus (numpy codes or a tensor) and keeps only its id slice of it.

    ``slack`` pads each shard's row capacity over the uniform expectation;
    value-space skew beyond it raises (the exactness contract forbids
    silently dropping rows)."""
    mesh_tables(mesh, cfg)
    _check_member(mesh)
    n_shards = mesh.shape["shard"]
    n_dev = mesh.n_model
    n = codes_arr.shape[0]
    if codes_arr.shape[1] != cfg.n_words:
        raise ValueError(f"codes have {codes_arr.shape[1]} words, config "
                         f"wants {cfg.n_words}")
    # id-shard the corpus (pad rows to the device multiple; pad ids >= n
    # are filtered out inside the build)
    unit = n_dev * 128
    n_tot = -(-max(n, 1) // unit) * unit
    pbits = pbits or dir_lib.pick_range_pbits(n, cfg.s_bits, ID_ROW_BLOCK)
    pbits = max(pbits, (n_shards - 1).bit_length())
    if (1 << pbits) % n_shards:
        raise ValueError(f"2^pbits={1 << pbits} not divisible by "
                         f"{n_shards} shards")
    n_loc = n_tot // n_dev
    codes_loc = _local_codes(codes_arr, n, n_loc, mesh.model_index,
                             mesh.device)
    # uniform expectation n_tot/S rows per (table, shard), padded by slack
    cap_rows = int(-(-int(n_tot // n_shards * slack) // ID_ROW_BLOCK)
                   * ID_ROW_BLOCK)
    idrows, se, kept = _build_local(mesh, codes_loc, cfg, n=n, pbits=pbits,
                                    cap_rows=cap_rows)
    kept_max = int(collectives.reduce_max(kept, mesh.model_group))
    if kept_max > cap_rows:
        raise ValueError(
            f"value-space skew overflowed shard capacity: max kept "
            f"{kept_max} > cap {cap_rows}; rebuild with larger "
            f"slack (exactness contract: rows must never be dropped)")
    return ShardedCompactIndex(cfg=cfg, mesh=mesh, n=n, pbits=pbits,
                               cap_rows=cap_rows, idrows=idrows, se=se,
                               codes=codes_loc)


def _build_local(mesh: Mesh, codes_loc: torch.Tensor, cfg: MIHConfig, *,
                 n: int, pbits: int, cap_rows: int):
    """Stream -> filter -> append -> sort -> local directory, for this
    rank's tables: ``(idrows, se, kept)``, kept = the most rows any of its
    tables received (a 0-d tensor). The corpus passes once through the
    plane's ``all_gather``, ``BUILD_CHUNK`` rows of every rank's slice at a
    time; a clamped last chunk re-reads rows of the one before, which the
    freshness mask drops, so no row is indexed twice."""
    dev = mesh.device
    n_loc, w = codes_loc.shape
    n_dev = mesh.n_model
    s_bits = cfg.s_bits
    chunk = min(n_loc, BUILD_CHUNK)
    shift = s_bits - pbits
    p_loc = (1 << pbits) // mesh.shape["shard"]
    p0 = mesh.coords[1] * p_loc
    tables = _my_tables(mesh, cfg)
    # one dump slot past the capacity takes every dropped row
    keys = [torch.full((cap_rows + 1,), -1, dtype=torch.int32, device=dev)
            for _ in tables]
    # pad id int32-max: pads sort AFTER real rows sharing the all-ones
    # substring key, keeping real rows contiguous [0, kept)
    ids = [torch.full((cap_rows + 1,), _PAD_ID, dtype=torch.int32,
                      device=dev) for _ in tables]
    off = [torch.zeros((), dtype=torch.int64, device=dev) for _ in tables]
    src = torch.arange(n_dev, device=dev).repeat_interleave(chunk)
    for c in range(-(-n_loc // chunk)):
        start = min(c * chunk, n_loc - chunk)
        rows = collectives.gather_rows(codes_loc[start:start + chunk],
                                       mesh.model_group)
        lpos = start + torch.arange(chunk, device=dev).repeat(n_dev)
        gid = src * n_loc + lpos
        fresh = (gid < n) & (lpos >= c * chunk)
        for j, t in enumerate(tables):
            sub = substring(rows, t, s_bits)
            pref = shr(sub, shift)
            keep = fresh & (pref >= p0) & (pref < p0 + p_loc)
            pos = off[j] + torch.cumsum(keep, 0) - 1
            idx = torch.where(keep & (pos < cap_rows), pos, cap_rows)
            keys[j].scatter_(0, idx, sub)
            ids[j].scatter_(0, idx, gid.to(torch.int32))
            off[j] = off[j] + keep.sum()
    top = p0 + p_loc >= 1 << pbits
    grid = (p0 + torch.arange(p_loc + 1, device=dev)) << shift
    out_ids, out_se = [], []
    for j in range(len(tables)):
        # local sort on (substring, id): bucket-internal order = ascending
        # id, the reference's append order
        k64 = (keys[j][:cap_rows].to(torch.int64) & 0xFFFFFFFF) << 31
        comb = torch.sort(k64 | ids[j][:cap_rows].to(torch.int64)).values
        del k64
        si = (comb & _PAD_ID).to(torch.int32)
        si = torch.where(si == _PAD_ID, -1, si)
        # boundary of prefix p = first row with key >= p << shift; the
        # last slice ends at its kept rows (its end value would pass the
        # 32-bit key range)
        offs = torch.searchsorted(comb >> 31, grid).to(torch.int32)
        del comb
        if top:
            offs[-1] = off[j].to(torch.int32)
        out_se.append(torch.stack([offs[:-1], offs[1:]], dim=-1))
        out_ids.append(si.reshape(cap_rows // ID_ROW_BLOCK, ID_ROW_BLOCK))
    return (torch.stack(out_ids), torch.stack(out_se),
            torch.stack(off).max())


# --------------------------------------------------------------------------
# Persistence: one file per (array, shard offset), the reference's names
# --------------------------------------------------------------------------

_SHARD_SAVE_META = "meta.json"
_FORMAT = "verticut_tpu.sharded_compact.v1"


def _shards(cfg: MIHConfig, mesh: Mesh, cap_rows: int, pbits: int,
            n_loc: int):
    """``(name, global offset, dtype)`` of this rank's slice of each model
    array, as the reference names its shard files (``{name}_{offset}``,
    the offset of the shard's first element on each axis)."""
    t, s, _ = mesh.coords
    tl = mesh_tables(mesh, cfg)
    t_off = t * tl if mesh.shape["table"] > 1 else 0
    p_loc = (1 << pbits) // mesh.shape["shard"]
    return (("idrows", (t_off, s * cap_rows // ID_ROW_BLOCK, 0), np.uint32),
            ("se", (t_off, s * p_loc, 0), np.int32),
            ("codes", (mesh.model_index * n_loc, 0), np.uint32))


def _shard_file(path: str, name: str, off) -> str:
    return os.path.join(path, f"{name}_{'_'.join(map(str, off))}.npy")


def _mesh_barrier(mesh: Mesh) -> None:
    """Every rank of the mesh has reached this point: each plane meets,
    then each query line, which holds one rank of every plane."""
    for g in (mesh.model_group, mesh.query_group):
        if mesh.device.type == "cuda":
            dist.barrier(group=g, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=g)


def save_sharded_compact(path: str, index: ShardedCompactIndex) -> None:
    """Persist the index under directory ``path``: every rank of query
    index 0 writes its slices, one ``.npy`` per (array, shard offset) in
    the reference's dtypes (the query axis's replicas write nothing), and
    rank (0, 0, 0) the reference's ``meta.json`` (config, model axes,
    global shapes). Either package loads the other's save onto the same
    table and shard axes; returns once every rank has written."""
    mesh = index.mesh
    _check_member(mesh)
    os.makedirs(path, exist_ok=True)
    n_loc = index.codes.shape[0]
    arrays = {"idrows": index.idrows, "se": index.se, "codes": index.codes}
    if mesh.coords[2] == 0:
        for name, off, dt in _shards(index.cfg, mesh, index.cap_rows,
                                     index.pbits, n_loc):
            np.save(_shard_file(path, name, off),
                    arrays[name].cpu().numpy().view(dt))
    if mesh.coords == (0, 0, 0):
        d = mesh.n_model
        x, y, z = index.idrows.shape
        shapes = {
            "idrows": [index.cfg.n_tables, index.n_shards * y, z],
            "se": [index.cfg.n_tables, index.se.shape[1] * index.n_shards,
                   2],
            "codes": [n_loc * d, index.codes.shape[1]]}
        meta = {
            "format": _FORMAT,
            "bits": index.cfg.bits,
            "n_tables": index.cfg.n_tables,
            "n": index.n,
            "pbits": index.pbits,
            "cap_rows": index.cap_rows,
            "mesh_table": mesh.shape["table"],
            "mesh_shard": mesh.shape["shard"],
            "arrays": {k: {"shape": v, "dtype": "int32" if k == "se"
                           else "uint32"} for k, v in shapes.items()},
        }
        with open(os.path.join(path, _SHARD_SAVE_META), "w") as f:
            json.dump(meta, f, indent=1)
    _mesh_barrier(mesh)


def load_sharded_compact(path: str, mesh: Mesh) -> ShardedCompactIndex:
    """Restore a saved index onto ``mesh``, whose table and shard axes must
    be those it was saved with (the query axis is free: the model arrays
    replicate over it). Each rank reads only its own shard files, so no
    host holds a copy of the whole index."""
    _check_member(mesh)
    with open(os.path.join(path, _SHARD_SAVE_META)) as f:
        meta = json.load(f)
    if (meta["mesh_table"] != mesh.shape["table"]
            or meta["mesh_shard"] != mesh.shape["shard"]):
        raise ValueError(
            f"saved for mesh (table={meta['mesh_table']}, "
            f"shard={meta['mesh_shard']}); got (table={mesh.shape['table']}"
            f", shard={mesh.shape['shard']}) — resharding a saved index "
            "requires a rebuild")
    cfg = MIHConfig(bits=int(meta["bits"]), n_tables=int(meta["n_tables"]))
    cap_rows, pbits = int(meta["cap_rows"]), int(meta["pbits"])
    n_loc = meta["arrays"]["codes"]["shape"][0] // mesh.n_model
    out = {}
    for name, off, _dt in _shards(cfg, mesh, cap_rows, pbits, n_loc):
        a = np.load(_shard_file(path, name, off), mmap_mode="r")
        out[name] = torch.from_numpy(np.array(a).view(np.int32)).to(
            mesh.device)
    return ShardedCompactIndex(
        cfg=cfg, mesh=mesh, n=int(meta["n"]), pbits=pbits, cap_rows=cap_rows,
        idrows=out["idrows"], se=out["se"], codes=out["codes"])


# --------------------------------------------------------------------------
# The compact radius step: local id discovery -> owner scoring -> merge
# --------------------------------------------------------------------------

#: gathered code words per scoring slice (~32 MB of int32)
SCORE_SLICE_WORDS = 1 << 23


def sharded_compact_radius_step(mesh: Mesh, idrows, se, codes_loc, queries,
                                q_subs, masks, state: SearchState, *,
                                radius: int, n_tables: int, knn: int,
                                cap: int, approximate: bool, s_bits: int,
                                pbits: int) -> SearchState:
    """One radius step on this rank's slices (the reference's
    ``_device_radius_step_compact``): ``idrows [tl, NBl, 32]``, ``se [tl,
    p_loc, 2]`` (local row coordinates), ``codes_loc [n_loc, W]`` (this
    rank's id range), ``queries [Ql, W]``."""
    t0, s0, _ = mesh.coords
    n_mesh_tables, n_shards = mesh.shape["table"], mesh.shape["shard"]
    tl, nbl = idrows.shape[0], idrows.shape[1]
    blk = ID_ROW_BLOCK
    chb = max(4, cap // blk)
    shift = s_bits - pbits
    p_loc = (1 << pbits) // n_shards
    p0 = s0 * p_loc
    n_loc = codes_loc.shape[0]
    c0 = mesh.model_index * n_loc
    active = ~state.done
    nq = queries.shape[0]
    pos = torch.arange(blk, dtype=torch.int32, device=queries.device)

    ids_t = []
    n_probe = torch.zeros_like(state.n_probes)
    n_nonempty = torch.zeros_like(state.n_nonempty)
    overflow_l = torch.zeros_like(state.done)
    for tt in range(tl):
        tglob = t0 * tl + tt if n_mesh_tables > 1 else tt
        pref = shr(q_subs[:, tglob], shift)[:, None] ^ masks[None, :]
        owned = (pref >= p0) & (pref < p0 + p_loc)
        p = se[tt][(pref - p0).clamp(0, p_loc - 1).long()]
        counts = torch.where(owned & active[:, None], p[..., 1] - p[..., 0],
                             0)
        # each probe is owned by exactly one shard: count it there
        n_probe += torch.where(active, owned.sum(-1, dtype=torch.int32), 0)
        n_nonempty += (counts > 0).sum(dim=-1, dtype=torch.int32)
        blk_id, lo, hi, _nch, ovf = chunks_lib.chunk_descriptors(
            p[..., 0], counts, blk=blk, chb=chb, n_blocks=nbl)
        cid = idrows[tt][blk_id.long()]                    # [Q, chb, 32]
        ok = (pos >= lo[..., None]) & (pos < hi[..., None]) & (cid >= 0)
        ids_t.append(torch.where(ok, cid, -1).reshape(nq, chb * blk))
        overflow_l |= ovf

    # collective 1: every rank's candidate ids (4 B each) to every rank
    g = collectives._all_gather(torch.stack(ids_t, dim=1), mesh.model_group)
    # [D, Q, tl, C], D table-major then shard -> per global table groups
    c_width = g.shape[-1]
    g = (g.reshape(n_mesh_tables, n_shards, nq, tl, c_width)
         .permute(2, 0, 3, 1, 4).reshape(nq, n_tables, n_shards * c_width))

    # distance at the owner: score the ids whose codes live here, one
    # global table at a time, in width slices that bound the gathered
    # codes to ~32 MB (the single-device compact path's slicing)
    sw = g.shape[-1]
    p_sz = state.pool_dist.shape[-1]
    sl = max(blk, SCORE_SLICE_WORDS // max(nq * queries.shape[-1], 1))
    n_cands = torch.zeros_like(state.n_cands)
    sd, si = [], []
    for j in range(n_tables):
        d_parts, i_parts = [], []
        for c_lo in range(0, sw, sl):
            part = g[:, j, c_lo:c_lo + sl]
            own = (part >= c0) & (part < c0 + n_loc)
            rows = codes_loc[(part - c0).clamp(0, n_loc - 1).long()]
            dd = hamming_distance(rows, queries[:, None, :])
            d_parts.append(torch.where(own, dd, topk.INF_DIST))
            i_parts.append(torch.where(own, part, -1))
        dist_j = torch.cat(d_parts, dim=-1)
        ids_j = torch.cat(i_parts, dim=-1)
        n_cands += (ids_j >= 0).sum(dim=-1, dtype=torch.int32)
        # per-(global table, rank) strip: ids are unique within it, and
        # the candidate axis is id-block-major, so the chunk-min
        # pre-selection applies
        d_s, i_s = topk.table_topk_chunkmin_pos(dist_j, ids_j, p_sz, blk)
        sd.append(d_s)
        si.append(i_s)
    # collective 2: the strips back to everyone, replicated dedup merge
    gd, gi = collectives.gather_candidates(torch.cat(sd, dim=-1),
                                           torch.cat(si, dim=-1),
                                           mesh.model_group)
    pd, pi = topk.merge_strips_dedup_pos(state.pool_dist, state.pool_id,
                                         gd, gi)
    done, rad = _stop(pd, pi, state, radius=radius, knn=knn,
                      n_tables=n_tables, s_bits=s_bits,
                      approximate=approximate)
    # every probe has one owning shard, every table one finder row and
    # every candidate one code owner: the sums are exact counts
    return SearchState(pool_dist=pd, pool_id=pi, done=done, radius=rad,
                       **_reduce_stats(state, mesh.model_group, overflow_l,
                                       n_probe, n_nonempty, n_cands))


def sharded_compact_search(index: ShardedCompactIndex, queries,
                           scfg: SearchConfig = SearchConfig(),
                           _cap: Optional[int] = None) -> SearchResult:
    """Distributed compact K-NN; every rank of the mesh calls it with the
    same batch. Same contract as :func:`sharded_mih_search`; the fused
    pipeline always runs (the reference has no loop driver here), and with
    no enumerable stage the exact scan answers everything."""
    scfg = effective_scfg(scfg)
    queries = prepare_queries(index, queries)
    count_batch(queries, _cap)
    cfg, mesh = index.cfg, index.mesh
    k = scfg.knn
    schedule, masks, caps = range_stages(
        scfg, cfg, index.n, index.pbits, ID_ROW_BLOCK, index.device,
        cap=_cap, fused=True)
    if not schedule:
        ld, li = sharded_linear_search(mesh, index.codes, queries, k,
                                       n_total=index.n)
        z = torch.zeros(queries.shape[0], dtype=torch.int32)
        return SearchResult(dists=ld.cpu(), ids=li.cpu(), radius=z,
                            n_probes=z, n_nonempty=z, n_cands=z)
    n_loc = index.codes.shape[0]

    def step_fn(i, r, cap, cq, cqs, cs):
        with span("mih.sharded.step"):
            return sharded_compact_radius_step(
                mesh, index.idrows, index.se, index.codes, cq, cqs, masks[i],
                cs, radius=r, n_tables=cfg.n_tables, knn=k, cap=cap,
                approximate=scfg.approximate, s_bits=cfg.s_bits,
                pbits=index.pbits)

    def scan_fn(sq):
        return _device_linear(mesh, index.codes, sq, k, n_loc, index.n)

    q_loc = _local_rows(mesh, queries)
    state = run_fused(
        step_fn, scan_fn, q_loc, all_substrings(q_loc, cfg.n_tables), scfg,
        schedule=schedule, caps=caps, n=index.n)
    return _fallbacks(index, queries, scfg, _cap, sharded_compact_search,
                      gather_result(mesh, state, k))
