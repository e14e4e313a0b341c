"""Rank functions of the port's multi-device tests: each runs in every
process of a CPU world started by ``verticut_tpu_torch.parallel.world.
spawn`` and returns, per case, what the rank computed (numpy arrays), or
None on a rank the case's mesh leaves out.

A spawned process imports this module to find its function, so it imports
torch and the port only, never jax. The data of every case is made here
with numpy from a seed, and again in the test modules for the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from verticut_tpu_torch import codes
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.parallel import make_mesh

CFG4 = MIHConfig(bits=128, n_tables=4)


def make_db(n, seed=0, bits=128, clustered=False):
    if clustered:
        return codes.clustered_codes(seed, n, bits, n_clusters=16,
                                     flip_p=0.03)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    return codes.pack_bytes(raw)


def hot_db():
    """Half the corpus one repeated code: one run of equal keys per table
    that straddles the shard boundary (tests/test_sharded.py's
    adversary)."""
    rng = np.random.default_rng(77)
    hot = codes.random_codes(5, 1, 128)
    rest = codes.random_codes(6, 600, 128)
    packed = np.concatenate([np.repeat(hot, 600, axis=0), rest])
    return packed[rng.permutation(len(packed))], np.concatenate(
        [hot, rest[:15]])


def flipped_rows(packed, nq, seed, bits=128):
    """``nq`` random corpus rows with 3 random bits flipped each, drawn as
    tests/test_sharded.py's scale case draws them."""
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, len(packed), nq)
    qraw = codes.unpack_to_bytes(packed[sel])
    flips = rng.integers(0, bits, (nq, 3))
    for i in range(nq):
        for b in flips[i]:
            qraw[i, b // 8] ^= 1 << (b % 8)
    return codes.pack_bytes(qraw)


def as_np(res) -> dict:
    return {f: getattr(res, f).numpy() for f in res._fields}


# --------------------------------------------------------------------------
# The inline sharded engine (tests/test_torch_sharded.py)
# --------------------------------------------------------------------------

#: (name, mesh, cfg, db args, n queries, search config)
SHARDED_SEARCHES = [
    ("oracle_411", (4, 1, 1), CFG4, (600, 1), 16,
     SearchConfig(knn=10, candidate_cap=512)),
    ("oracle_421", (4, 2, 1), CFG4, (600, 1), 16,
     SearchConfig(knn=10, candidate_cap=512)),
    ("oracle_412", (4, 1, 2), CFG4, (600, 1), 16,
     SearchConfig(knn=10, candidate_cap=512)),
    ("loop_421", (4, 2, 1), CFG4, (600, 1), 16,
     SearchConfig(knn=10, candidate_cap=512, fused=False)),
    ("single_engine", (4, 2, 1), CFG4, (500, 2), 12,
     SearchConfig(knn=8, candidate_cap=512)),
    ("full_enum", (1, 8, 1), MIHConfig(bits=128, n_tables=16), (320, 3), 8,
     SearchConfig(knn=5, max_enum_radius=8, candidate_cap=1024,
                  fallback_ratio=1e9)),
    ("approx", (4, 1, 2), CFG4, (2000, 5), 8,
     SearchConfig(knn=5, approximate=True, approximate_factor=4,
                  candidate_cap=1024)),
    ("approx_loop", (4, 1, 2), CFG4, (2000, 5), 8,
     SearchConfig(knn=5, approximate=True, approximate_factor=4,
                  candidate_cap=1024, fused=False)),
    ("full_3d", (2, 2, 2), MIHConfig(bits=64, n_tables=2), (401, 9, 64), 8,
     SearchConfig(knn=6, candidate_cap=512)),
]


def sharded_db(name):
    """The corpus and queries of a search case."""
    if name.startswith("straddle"):
        return hot_db()
    case = next(c for c in SHARDED_SEARCHES if c[0] == name)
    db = make_db(*case[3][:2], bits=case[3][2] if len(case[3]) > 2 else 128)
    return db, db[:case[4]]


def run_sharded(rank):
    """Every case of the inline sharded engine, in one world of 8."""
    from verticut_tpu_torch.search.sharded import (build_sharded_index,
                                                   sharded_linear_search,
                                                   sharded_mih_search)
    out = {}
    for name, shape, cfg, _db, _nq, scfg in SHARDED_SEARCHES:
        mesh = make_mesh(*shape)
        if not mesh.member:
            out[name] = None
            continue
        db, q = sharded_db(name)
        idx = build_sharded_index(db, cfg, mesh, pbits=None)
        out[name] = as_np(sharded_mih_search(idx, q, scfg))

    mesh = make_mesh(4, 2, 1)
    db, q = hot_db()
    if mesh.member:
        idx = build_sharded_index(db, CFG4, mesh)
        for name, fused in (("straddle", True), ("straddle_loop", False)):
            out[name] = as_np(sharded_mih_search(
                idx, q, SearchConfig(knn=10, candidate_cap=256,
                                     fused=fused)))
    else:
        out["straddle"] = out["straddle_loop"] = None

    # a mesh whose table axis is neither 1 nor m raises, before any
    # collective, on every rank of it
    mesh = make_mesh(2, 2, 2)
    try:
        build_sharded_index(make_db(64), CFG4, mesh)
        out["raises_222"] = "built"
    except ValueError as e:
        out["raises_222"] = str(e)

    mesh = make_mesh(4, 2, 1)
    out["collectives"] = _collectives(mesh) if mesh.member else None
    out.update(_builds())
    out.update(_wide_ids())
    db = make_db(333, seed=4)             # not divisible by 8
    if mesh.member:
        idx = build_sharded_index(db, MIHConfig(), mesh)
        d, i = sharded_linear_search(mesh, idx.codes, db[:8], 7,
                                     n_total=idx.n)
        out["linear"] = {"dists": d.numpy(), "ids": i.numpy()}
    else:
        out["linear"] = None
    return out


#: (name, mesh, cfg, n): the sharded build against its plain copy. The
#: shard unit is n_shards * 200 entries: no n here is a multiple of it;
#: at 100 over 4 shards, shards 1-3 hold pads alone
BUILDS = [
    ("build_411", (4, 1, 1), CFG4, 1001),
    ("build_141", (1, 4, 1), CFG4, 1001),
    ("build_122", (1, 2, 2), CFG4, 1001),
    ("build_114", (1, 1, 4), CFG4, 1001),
    ("build_141_n100", (1, 4, 1), CFG4, 100),
    # 16-bit substrings: the pads lie past every range
    ("build_141_s16", (1, 4, 1), MIHConfig(bits=128, n_tables=8), 1001),
]


def plain_make_entry_rows(sorted_ids, codes):
    """``index.mih.make_entry_rows`` as it was before it could build a
    slice: the whole padded table, its ids padded in one copy."""
    from verticut_tpu_torch.index.mih import (entry_block_size,
                                              entry_row_align)
    n, w = codes.shape
    rw, blk = 1 + w, entry_block_size(w)
    npad = -(-max(n, 1) // entry_row_align(w)) * entry_row_align(w)
    ids = torch.full((npad,), -1, dtype=torch.int32)
    ids[:sorted_ids.shape[0]] = sorted_ids
    g = codes[ids.clamp(min=0).long()]
    g[ids < 0] = 0
    return torch.cat([ids[:, None], g], dim=1).reshape(
        -1, blk, rw).transpose(1, 2).reshape(-1, blk * rw)


def plain_build(db, cfg, mesh) -> dict:
    """``search.sharded.build_sharded_index`` as it was before it was cut
    to fit 1B codes a rank: the padded corpus, the padded substrings and
    the whole table's rows, then a copy of this rank's slices."""
    from verticut_tpu_torch.index import directory as dir_lib
    from verticut_tpu_torch.index.mih import (entry_block_size,
                                              entry_row_align, sort_table)
    from verticut_tpu_torch.search.sharded import _my_tables
    codes_t = torch.from_numpy(db.view(np.int32))
    n, w = codes_t.shape
    blk = entry_block_size(w)
    n_shards = mesh.shape["shard"]
    unit = n_shards * entry_row_align(w)
    n_tot = -(-n // unit) * unit
    n_pad = n_tot - n
    pbits = dir_lib.pick_range_pbits(n, cfg.s_bits, blk)
    padded = torch.cat([codes_t, codes_t.new_zeros((n_pad, w))])
    nb_loc = n_tot // blk // n_shards
    s0 = mesh.coords[1]
    rows_t, se_t = [], []
    for t in _my_tables(mesh, cfg):
        subs, ids = sort_table(codes_t, t, cfg.s_bits)
        subs = torch.cat([subs, subs.new_full((n_pad,), -1)])
        rows = plain_make_entry_rows(ids, padded)
        rows_t.append(rows[s0 * nb_loc:(s0 + 1) * nb_loc].clone())
        se_t.append(dir_lib.build_range(subs, cfg.s_bits, pbits=pbits).se)
    n_loc = n_tot // mesh.n_model
    c0 = mesh.model_index * n_loc
    return {"entry_rows": torch.stack(rows_t).numpy(),
            "se": torch.stack(se_t).numpy(),
            "codes": padded[c0:c0 + n_loc].numpy(), "n_rows": n_tot}


def _builds() -> dict:
    """Each build case on every rank of its mesh: this rank's slices from
    ``build_sharded_index`` and from its plain copy."""
    from verticut_tpu_torch.search.sharded import build_sharded_index
    out = {}
    for name, shape, cfg, n in BUILDS:
        mesh = make_mesh(*shape)
        if not mesh.member:
            out[name] = None
            continue
        db = make_db(n, seed=n)
        idx = build_sharded_index(db, cfg, mesh)
        out[name] = {"new": {"entry_rows": idx.entry_rows.numpy(),
                             "se": idx.se.numpy(),
                             "codes": idx.codes.numpy(),
                             "n_rows": idx.n_rows},
                     "old": plain_build(db, cfg, mesh)}
    return out


#: the wide-id case: corpus size, query rows (near duplicates, then
#: uniform codes that reach the scan tier) and search settings
WIDE_N, WIDE_NEAR, WIDE_FAR = 3000, 24, 8
WIDE_SCFG = SearchConfig(knn=10, candidate_cap=512)
#: the spans the sharded path records under a profiler
SHARDED_SPANS = ("mih.sharded.step", "mih.fetch_score", "mih.sharded.scan",
                 "mih.sharded.gather_result", "coll.all_gather",
                 "coll.all_reduce")


def wide_db():
    """The wide-id case's corpus and queries."""
    db = make_db(WIDE_N, seed=17, clustered=True)
    q = np.concatenate([flipped_rows(db, WIDE_NEAR, 19),
                        codes.random_codes(23, WIDE_FAR, 128)])
    return db, q


def _wide_ids() -> dict:
    """The inline sharded engine at 4x1x1 with the packed selections
    refused, as ids of 1B codes refuse them: the ``_pos`` strips and the
    dedup merge. Returns per rank the answers of two calls, one under a
    CPU profiler, with the profiler's range names and what the counters
    added over both calls."""
    from verticut_tpu_torch.ops import topk
    from verticut_tpu_torch.search import sharded
    from verticut_tpu_torch.utils import timer
    mesh = make_mesh(4, 1, 1)
    if not mesh.member:
        return {"wide": None}
    db, q = wide_db()
    idx = sharded.build_sharded_index(db, CFG4, mesh)
    can_pack, packed_calls = topk.can_pack, []

    def refuse(*args):
        packed_calls.append(can_pack(*args))
        return False

    topk.can_pack = refuse
    try:
        before = timer.counters()
        first = as_np(sharded.sharded_mih_search(idx, q, WIDE_SCFG))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            second = as_np(sharded.sharded_mih_search(idx, q, WIDE_SCFG))
        added = timer.counters(since=before)
    finally:
        topk.can_pack = can_pack
    return {"wide": {
        "first": first, "second": second, "packed_calls": packed_calls,
        "counters": {k: v for k, v in added.items()
                     if k.startswith(("coll.", "mih.sharded_"))},
        "spans": sorted({e.name() for e in prof.profiler.kineto_results
                         .events()} & set(SHARDED_SPANS))}}


def _collectives(mesh) -> dict:
    """Each collective over the (table, shard) plane of a (4, 2, 1) mesh,
    on operands that name the rank (r = its place in the plane)."""
    from verticut_tpu_torch.parallel import collectives as c
    g, r = mesh.model_group, mesh.model_index
    word = torch.tensor([1 << r, -(1 << 31) if r == 7 else 0, 5],
                        dtype=torch.int32)
    gd, gi = c.gather_candidates(torch.full((2, 3), r, dtype=torch.int32),
                                 torch.full((2, 3), -r, dtype=torch.int32), g)
    return {
        "any": c.reduce_any(torch.tensor([r == 5, False]), g).numpy(),
        "sum": c.reduce_sum(torch.tensor([r, 1], dtype=torch.int32),
                            g).numpy(),
        "max": c.reduce_max(torch.tensor(r), g).numpy(),
        "or": c.reduce_bitmap_or(word, g).numpy(),
        "or_disjoint": c.reduce_bitmap_or(word[:2], g, disjoint=True).numpy(),
        "strips": c.gather_strips(torch.full((2, 1), r, dtype=torch.int64),
                                  g).numpy(),
        "cand_d": gd.numpy(), "cand_i": gi.numpy(),
    }


def run_sharded_scale(rank, db, q):
    """1M codes on a (4, 2, 1) mesh, k = 10 (the slow scale case)."""
    from verticut_tpu_torch.search.sharded import (build_sharded_index,
                                                   sharded_mih_search)
    mesh = make_mesh(4, 2, 1)
    idx = build_sharded_index(db, CFG4, mesh)
    return as_np(sharded_mih_search(idx, q, SearchConfig(knn=10)))


# --------------------------------------------------------------------------
# The compact sharded engine (tests/test_torch_sharded_compact.py)
# --------------------------------------------------------------------------

#: (name, mesh, db args (n, seed, clustered), slack, query rows, config)
COMPACT_SEARCHES = [
    ("oracle_421", (4, 2, 1), (1500, 3, False), 2.5, 8,
     SearchConfig(knn=5, candidate_cap=1024)),
    ("oracle_181", (1, 8, 1), (1500, 3, False), 2.5, 8,
     SearchConfig(knn=5, candidate_cap=1024)),
    ("oracle_412", (4, 1, 2), (1500, 3, False), 2.5, 16,
     SearchConfig(knn=5, candidate_cap=1024)),
    ("clustered_421", (4, 2, 1), (1500, 3, True), 2.5, 8,
     SearchConfig(knn=5, candidate_cap=1024)),
    ("exact_421", (4, 2, 1), (2000, 13, False), 2.5, 8,
     SearchConfig(knn=5)),
    ("approx_421", (4, 2, 1), (2000, 13, False), 2.5, 8,
     SearchConfig(knn=5, approximate=True, approximate_factor=5)),
]

#: the save/load cases: (name, saving mesh, loading query axis)
COMPACT_RELOADS = [("reload_421", (4, 2, 1), 1), ("reload_411", (4, 1, 1), 2)]


def compact_db(name):
    """The corpus and queries of a compact search or reload case."""
    for c in COMPACT_SEARCHES:
        if c[0] == name:
            n, seed, clustered = c[2]
            db = make_db(n, seed, clustered=clustered)
            return db, db[:c[4]]
    q_rows = 8 * dict((c[0], c[2]) for c in COMPACT_RELOADS)[name]
    db = make_db(1800, seed=21, clustered=True)
    return db, db[:q_rows]


def _global_slices(idx) -> dict:
    """This rank's slices and where they lie in the global arrays."""
    t, s, q = idx.mesh.coords
    return {"coords": (t, s, q), "idrows": idx.idrows.numpy(),
            "se": idx.se.numpy(), "pbits": idx.pbits,
            "cap_rows": idx.cap_rows}


def run_compact(rank, tmp):
    """Every case of the compact sharded engine, in one world of 8;
    ``tmp`` is a directory every rank can write."""
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, load_sharded_compact, save_sharded_compact,
        sharded_compact_search)
    out = {}
    for name, shape, _db, slack, _nq, scfg in COMPACT_SEARCHES:
        mesh = make_mesh(*shape)
        if not mesh.member:
            out[name] = None
            continue
        db, q = compact_db(name)
        idx = build_sharded_compact(db, CFG4, mesh, slack=slack)
        out[name] = as_np(sharded_compact_search(idx, q, scfg))

    mesh = make_mesh(4, 2, 1)
    out["build"] = (_global_slices(build_sharded_compact(
        make_db(700, seed=9), CFG4, mesh, slack=2.5)) if mesh.member
        else None)
    out["memory"] = (build_sharded_compact(
        make_db(4096, seed=5), CFG4, mesh, slack=1.5).memory_stats()
        if mesh.member else None)
    try:
        build_sharded_compact(np.repeat(make_db(1, seed=11), 2000, axis=0),
                              CFG4, mesh, slack=1.01)
        out["skew"] = "built"
    except ValueError as e:
        out["skew"] = str(e)

    for name, shape, reload_q in COMPACT_RELOADS:
        mesh = make_mesh(*shape)
        path = os.path.join(tmp, name)
        db, q = compact_db(name)
        if mesh.member:
            save_sharded_compact(path, build_sharded_compact(
                db, CFG4, mesh, slack=2.5))
        mesh2 = make_mesh(shape[0], shape[1], reload_q)
        if mesh2.member:
            idx2 = load_sharded_compact(path, mesh2)
            out[name] = dict(_global_slices(idx2), n=idx2.n, **as_np(
                sharded_compact_search(idx2, q, SearchConfig(
                    knn=5, candidate_cap=1024))))
        else:
            out[name] = None

    # a save loads only onto its own table and shard axes
    mesh = make_mesh(4, 2, 1)
    path = os.path.join(tmp, "reject")
    save_sharded_compact(path, build_sharded_compact(
        make_db(800, seed=23), CFG4, mesh, slack=2.5))
    try:
        load_sharded_compact(path, make_mesh(4, 1, 2))
        out["reject"] = "loaded"
    except ValueError as e:
        out["reject"] = str(e)

    # either package's save, loaded by the other (the reference saved
    # tmp/jax_saved before the world started; the port's save is loaded
    # by the reference after the world ends)
    db, q = interop_db()
    out["from_jax"] = as_np(sharded_compact_search(
        load_sharded_compact(os.path.join(tmp, "jax_saved"), mesh), q,
        SearchConfig(knn=5, candidate_cap=1024)))
    idx = build_sharded_compact(db, CFG4, mesh, slack=2.5)
    save_sharded_compact(os.path.join(tmp, "port_saved"), idx)
    out["port_saved"] = as_np(sharded_compact_search(
        idx, q, SearchConfig(knn=5, candidate_cap=1024)))
    return out


def interop_db():
    """The corpus and queries of the cross-package save/load case."""
    db = make_db(1600, seed=31, clustered=True)
    return db, db[:8]


def scale_db():
    """10M clustered codes (the compact scale case's corpus)."""
    n = 10_000_000
    return codes.clustered_codes(0, n, 128, n_clusters=n // 200, flip_p=0.02)


def run_compact_scale(rank):
    """10M codes on a (4, 2, 1) mesh, k = 10, 64 queries: the result and
    the memory stats."""
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, sharded_compact_search)
    db = scale_db()
    idx = build_sharded_compact(db, CFG4, make_mesh(4, 2, 1))
    return (as_np(sharded_compact_search(idx, db[:64], SearchConfig(knn=10))),
            idx.memory_stats())


# --------------------------------------------------------------------------
# Padded corpora on both sharded engines (tests/test_torch_sharded_pad.py)
# --------------------------------------------------------------------------

#: (name, mesh, engine, n, k). The inline build pads the corpus to a
#: multiple of n_shards * 200 rows, the compact build to one of 128 rows
#: per rank: no n here is a multiple. inline_100_421: 50 rows per rank,
#: ranks 0-1 real (fewer than k), 2-7 all pads; compact_1100_421: 256 rows
#: per rank, rank 4 holds 76 real rows, ranks 5-7 none.
PAD_CASES = [
    (f"{engine}_{n}_{''.join(map(str, shape))}", shape, engine, n, 10)
    for engine in ("inline", "compact") for shape in ((1, 2, 1), (4, 2, 1))
    for n in (1000, 1001)
] + [
    ("inline_100_421", (4, 2, 1), "inline", 100, 64),
    ("compact_1100_421", (4, 2, 1), "compact", 1100, 100),
]

#: the entry points each padded case runs
PAD_ENTRIES = ("linear", "fused", "loop")


def pad_db(n):
    """``n`` uniform codes and 16 queries near the all-zero pad rows: the
    zero code, codes with 1 to 8 set bits, and 7 corpus rows."""
    db = make_db(n, seed=0)
    rng = np.random.default_rng(n)
    bits = np.zeros((16, 128), np.uint8)
    for b in range(1, 9):
        bits[b, rng.choice(128, b, replace=False)] = 1
    q = codes.pack_bytes(np.packbits(bits, axis=1, bitorder="little"))
    q[9:] = db[np.linspace(0, n - 1, 7).astype(int)]
    return db, q


def run_pad(rank):
    """Every padded case through ``sharded_linear_search`` and the
    engine's search under both drivers, in one world of 8."""
    from verticut_tpu_torch.search.sharded import (build_sharded_index,
                                                   sharded_linear_search,
                                                   sharded_mih_search)
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, sharded_compact_search)
    out = {}
    for name, shape, engine, n, k in PAD_CASES:
        mesh = make_mesh(*shape)
        if not mesh.member:
            out[name] = None
            continue
        db, q = pad_db(n)
        if engine == "inline":
            idx = build_sharded_index(db, CFG4, mesh)
            search = sharded_mih_search
        else:
            idx = build_sharded_compact(db, CFG4, mesh)
            search = sharded_compact_search
        d, i = sharded_linear_search(mesh, idx.codes, q, k, n_total=idx.n)
        out[name] = {"linear": {"dists": d.numpy(), "ids": i.numpy()}}
        for entry, fused in (("fused", True), ("loop", False)):
            out[name][entry] = as_np(search(idx, q, SearchConfig(
                knn=k, fused=fused)))
    out["server"] = _pad_server(rank)
    return out


def _pad_server(rank):
    """The sharded server on rank 0 of a (4, 2, 1) mesh over the padded
    corpus of 1001 codes, the other ranks following: rank 0 returns the
    ``search_batch`` answer to the 16 near-pad queries at k = 10."""
    from verticut_tpu_torch.search.sharded import build_sharded_index
    from verticut_tpu_torch.service import (ImageSearchClient,
                                            ImageSearchServer, follow)
    db, q = pad_db(1001)
    idx = build_sharded_index(db, CFG4, make_mesh(4, 2, 1))
    if rank:
        follow(idx)
        return None
    srv = ImageSearchServer(idx, port=0, sharded=True).start()
    try:
        cli = ImageSearchClient(port=srv.port, timeout=60)
        got = cli.search_batch(codes.unpack_to_bytes(q).tobytes(), 10)
        cli.close()
    finally:
        srv.stop()
    return got


# --------------------------------------------------------------------------
# The sharded server (tests/test_torch_sharded_service.py)
# --------------------------------------------------------------------------

SERVE_IDS = [0, 3, 17, 250, 999, 1500, 1999, 42, 7, 1234, 77, 600, 5, 1800,
             333, 1024]


def _answers(res, k):
    """A SearchResult as the RPC returns it: [[id, dist], ...] per row."""
    return [[[i, d] for i, d in zip(ids, ds) if i >= 0]
            for ids, ds in zip(res.ids.tolist(), res.dists.tolist())]


def _server_rows(n, n_query):
    """The rows of a batch of ``n`` as the sharded server pads it."""
    n_rows = max(8, 1 << (n - 1).bit_length())
    return -(-n_rows // n_query) * n_query


def run_server(rank, shape):
    """A sharded server on rank 0 of a world that its mesh spans, the other
    ranks following it. Returns on rank 0 what 16 client threads and one
    batch request were served, and ``sharded_mih_search``'s answers on
    the same rows, then what a request with a bad ``knn`` was answered, what
    a batch failing on every rank after its broadcast raised, and the
    answer to a valid request after both; on the others, the number of
    batches followed."""
    from concurrent.futures import ThreadPoolExecutor

    from verticut_tpu_torch.search.sharded import (build_sharded_index,
                                                   sharded_mih_search)
    from verticut_tpu_torch.service import (ImageSearchClient,
                                            ImageSearchServer, follow)
    mesh = make_mesh(*shape)
    db = make_db(2000, seed=41)
    idx = build_sharded_index(db, CFG4, mesh)
    batch = flipped_rows(db, 12, 5)
    n_pad = _server_rows(12, shape[2]) - 12
    id_rows = SERVE_IDS + SERVE_IDS[:1] * (_server_rows(16, shape[2]) - 16)
    want_ids = _answers(sharded_mih_search(idx, db[id_rows],
                                           SearchConfig(knn=10)), 10)[:16]
    want_batch = _answers(sharded_mih_search(idx, np.concatenate(
        [batch, np.repeat(batch[:1], n_pad, axis=0)]), SearchConfig(knn=5)),
        5)
    if rank:
        return follow(idx)
    srv = ImageSearchServer(idx, port=0, sharded=True).start()
    try:
        cli = ImageSearchClient(port=srv.port, pool=16, timeout=60)
        with ThreadPoolExecutor(16) as ex:
            got_ids = list(ex.map(lambda i: cli.search_image_by_id(i, 10),
                                  SERVE_IDS))
        got_batch = cli.search_batch(codes.unpack_to_bytes(batch).tobytes(),
                                     5)
        got_code = cli.search_by_code(
            codes.unpack_to_bytes(db[SERVE_IDS[3:4]]).tobytes(), 10)
        # refused on rank 0 before anything is broadcast
        try:
            bad_rpc = cli.search_image_by_id(SERVE_IDS[0], 0)
        except RuntimeError as e:
            bad_rpc = str(e)
        # past the request checks: the batch fails on every rank alike
        try:
            bad_batch = srv._search(np.array(SERVE_IDS[:2]), 0, False)
        except RuntimeError as e:
            bad_batch = str(e)
        got_after = cli.search_image_by_id(SERVE_IDS[1], 10)
        stats = cli.stats()
        cli.close()
    finally:
        srv.stop()
    return dict(got_ids=got_ids, want_ids=want_ids, got_batch=got_batch,
                want_batch=want_batch[:12], got_code=got_code,
                bad_rpc=bad_rpc, bad_batch=bad_batch, got_after=got_after,
                n_batches=stats["n_batches"])


def run_own_world_of_one(rank):
    """Leaves the spawned world and starts a world of one with
    ``single_device_mesh`` on the CPU. Returns its mesh's shape and
    coordinates, its backend, and whether its store directory existed
    while it ran and after ``close_world``."""
    import torch.distributed as dist

    from verticut_tpu_torch.parallel import single_device_mesh, world
    world.close_world()
    mesh = single_device_mesh("cpu")
    store = world._store_dir
    out = dict(shape=mesh.shape, coords=mesh.coords,
               backend=dist.get_backend(), during=os.path.isdir(store))
    world.close_world()
    out["after"] = os.path.exists(store)
    return out


# --------------------------------------------------------------------------
# A world of one on the card (tests/test_torch_gpu.py)
# --------------------------------------------------------------------------

def run_world_of_one(rank):
    """Both sharded engines in a world of one on the card (NCCL), beside
    the port's mih_search on the same corpus: returns the backend and, per
    case, both results."""
    import torch.distributed as dist

    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.search import mih_search
    from verticut_tpu_torch.search.sharded import (build_sharded_index,
                                                   sharded_mih_search)
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, sharded_compact_search)
    mesh = make_mesh(1, 1, 1)
    db = codes.clustered_codes(0, 20000, 128, n_clusters=100, flip_p=0.02)
    q = flipped_rows(db, 256, 3)
    out = {"backend": dist.get_backend(), "device": str(mesh.device)}
    sidx = build_sharded_index(db, CFG4, mesh)
    cidx = build_sharded_compact(db, CFG4, mesh)
    inline = build_index(db, CFG4, device=mesh.device)
    compact = build_index(db, CFG4, store_codes=False, device=mesh.device)
    for fused in (True, False):
        scfg = SearchConfig(knn=10, fused=fused)
        out[f"inline_{fused}"] = (as_np(sharded_mih_search(sidx, q, scfg)),
                                  as_np(mih_search(inline, q, scfg)))
    scfg = SearchConfig(knn=10)
    out["compact"] = (as_np(sharded_compact_search(cidx, q, scfg)),
                      as_np(mih_search(compact, q, scfg)))
    return out


def run_loaded_compact(rank, paths, q):
    """The command-line build's ``--mesh 4x1x1`` case: each saved compact
    index of ``paths`` loaded onto a 4x1x1 mesh, and one k = 10 batch of
    ``q`` on it."""
    from verticut_tpu_torch.search.sharded_compact import (
        load_sharded_compact, sharded_compact_search)
    mesh = make_mesh(4, 1, 1)
    return [as_np(sharded_compact_search(load_sharded_compact(p, mesh), q,
                                         SearchConfig(knn=10)))
            for p in paths]
