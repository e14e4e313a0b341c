"""The port's compact sharded engine (value-partitioned shards, per-rank
streaming build, distance at the owner) against the JAX package's, on the
meshes of tests/test_sharded_compact.py.

The port runs in one gloo world of 8 CPU processes
(``torch_world_cases.run_compact``) while this process runs the reference
on its 8 virtual CPU devices. Held (tolerance 0): dists and radius /
n_probes / n_nonempty / n_cands equal to JAX's engine; ids equal to the
port's single-device compact engine and to brute force (below each row's
kth distance, every id at its true distance: the reference selects
strips by slot, the port by id, ROADMAP.md Queue 3); the build's id rows
and directories equal to JAX's and to a host sort; ``memory_stats``
equal; a save by either package loaded by the other; every rank of a
mesh returning the same result.
"""

import dataclasses
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax.numpy as jnp

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig as JMIHConfig
from verticut_tpu.config import SearchConfig as JSearchConfig
from verticut_tpu.parallel import make_mesh as jax_make_mesh
from verticut_tpu.search.sharded_compact import (
    build_sharded_compact as jax_build, load_sharded_compact as jax_load,
    save_sharded_compact as jax_save, sharded_compact_search as jax_search)

import torch_world_cases as cases
from verticut_tpu_torch.bits import as_codes
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.parallel.world import spawn
from verticut_tpu_torch.search import linear_search, mih_search

FIELDS = ("dists", "radius", "n_probes", "n_nonempty", "n_cands")
JCFG = JMIHConfig(bits=128, n_tables=4)
SCFG = JSearchConfig(knn=5, candidate_cap=1024)


@pytest.fixture(scope="module")
def world():
    """``(future of the port's results, shared directory)``: the reference
    saves its index for the port to load, then the world of 8 runs every
    case while the tests run the reference."""
    tmp = tempfile.mkdtemp(prefix="vt_compact_")
    db, _ = cases.interop_db()
    jax_save(os.path.join(tmp, "jax_saved"),
             jax_build(db, JCFG, jax_make_mesh(4, 2, 1), slack=2.5))
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(spawn, cases.run_compact, 8, tmp, device="cpu",
                        threads=1), tmp
    shutil.rmtree(tmp, ignore_errors=True)


def port_case(world, name):
    """The case's result, after checking that every rank of its mesh
    returned the same one."""
    got = [r[name] for r in world[0].result() if r[name] is not None]
    assert got, name
    for other in got[1:]:
        for f in ("dists", "ids") + FIELDS[1:]:
            if f in got[0]:
                assert np.array_equal(other[f], got[0][f]), (name, f)
    return got[0]


def assert_jax(got, want):
    for f in FIELDS:
        assert np.array_equal(got[f], np.asarray(getattr(want, f))), f


def assert_oracle(got, db, q, k):
    """Dists equal to brute force; ids equal below each row's kth
    distance, and every id at its returned distance."""
    ld, li = linear_search(as_codes(q, "cpu"), as_codes(db, "cpu"), k,
                           method="popcount")
    ld, li = ld.numpy(), li.numpy()
    assert np.array_equal(got["dists"], ld)
    below = ld < ld[:, -1:]
    assert np.array_equal(np.where(below, got["ids"], -1),
                          np.where(below, li, -1))
    valid = got["ids"] >= 0
    true = np.asarray(jcodes.hamming_distance(
        jnp.asarray(db)[np.clip(got["ids"], 0, None)],
        jnp.asarray(q)[:, None, :]))
    assert np.array_equal(true[valid], got["dists"][valid])
    assert (got["dists"][:, 0] == 0).all()        # self-match


def assert_single_engine(got, db, q, scfg):
    """Dists and ids equal to the port's single-device compact engine."""
    idx = build_index(db, cases.CFG4, store_codes=False, directory="range",
                      device="cpu")
    one = mih_search(idx, q, scfg)
    assert np.array_equal(got["dists"], one.dists.numpy())
    assert np.array_equal(got["ids"], one.ids.numpy())


@pytest.mark.parametrize("name", [c[0] for c in cases.COMPACT_SEARCHES])
def test_compact_sharded_matches_jax(world, name):
    _, shape, _, slack, _, scfg = next(c for c in cases.COMPACT_SEARCHES
                                       if c[0] == name)
    db, q = cases.compact_db(name)
    jscfg = JSearchConfig(**dataclasses.asdict(scfg))
    want = jax_search(jax_build(db, JCFG, jax_make_mesh(*shape),
                                slack=slack), q, jscfg)
    got = port_case(world, name)
    assert_jax(got, want)
    assert (got["n_probes"] > 0).all() and (got["n_cands"] >= 1).all()
    if scfg.approximate:
        exact = port_case(world, "exact_421")
        assert (got["dists"].sum(-1) >= exact["dists"].sum(-1)).all()
        assert (got["dists"][:, 0] == 0).all()
    else:
        assert_oracle(got, db, q, scfg.knn)
        assert_single_engine(got, db, q, scfg)


def _assemble(slices, shape_t, shape_s):
    """The global id rows and directories from every rank's slices."""
    parts = [s for s in slices if s is not None]
    tl, y, z = parts[0]["idrows"].shape
    p_loc = parts[0]["se"].shape[1]
    idrows = np.zeros((tl * shape_t, y * shape_s, z), np.int32)
    se = np.zeros((tl * shape_t, p_loc * shape_s, 2), np.int32)
    for p in parts:
        t, s, _ = p["coords"]
        idrows[t * tl:(t + 1) * tl, s * y:(s + 1) * y] = p["idrows"]
        se[t * tl:(t + 1) * tl, s * p_loc:(s + 1) * p_loc] = p["se"]
    return idrows, se


def test_compact_build_matches_jax_and_central_reference(world):
    """Every (id, substring) pair indexed exactly once, each prefix range
    pointing at exactly the ids with that prefix (the integrity_check.cc
    analog for the distributed build), and the id rows and directories
    bit-equal to the reference's build."""
    db = cases.make_db(700, seed=9)
    slices = [r["build"] for r in world[0].result()]
    idrows, se = _assemble(slices, 4, 2)
    jidx = jax_build(db, JCFG, jax_make_mesh(4, 2, 1), slack=2.5)
    assert np.array_equal(idrows, np.asarray(jidx.idrows).view(np.int32))
    assert np.array_equal(se, np.asarray(jidx.se))
    p = next(s for s in slices if s is not None)
    rows_per_shard, pbits = p["cap_rows"], p["pbits"]
    p_loc = (1 << pbits) // 2
    shift = 32 - pbits
    subs = np.stack([np.asarray(jcodes.substring(jnp.asarray(db), t, 32))
                     for t in range(4)], axis=1)
    for t in range(4):
        ids_flat = idrows[t].reshape(-1).astype(np.int64)
        got = []
        for s in range(2):
            sl = ids_flat[s * rows_per_shard:(s + 1) * rows_per_shard]
            got.append(sl[sl != -1])
        assert sorted(np.concatenate(got)) == list(range(len(db))), t
        for s in range(2):
            base = s * rows_per_shard
            for lp in range(0, p_loc, max(1, p_loc // 7)):
                pref = s * p_loc + lp
                st, en = se[t, pref]
                expect = np.nonzero((subs[:, t] >> shift) == pref)[0]
                assert sorted(ids_flat[base + st:base + en]) == sorted(
                    expect), (t, s, lp)


def test_compact_memory_stats_match_jax(world):
    n = 4096
    want = jax_build(cases.make_db(n, seed=5), JCFG, jax_make_mesh(4, 2, 1),
                     slack=1.5).memory_stats()
    stats = [r["memory"] for r in world[0].result() if r["memory"]]
    assert all(s == want for s in stats), (stats[0], want)
    st = stats[0]
    assert st["codes_bytes"] >= n * 16
    assert n * 4 * 4 <= st["idrows_bytes"] <= n * 4 * 4 * 2.2
    assert st["bytes_per_device"] * st["n_devices"] == st["total_bytes"]
    assert 30 <= st["bytes_per_code"] <= 120


def test_compact_build_raises_on_value_skew_overflow(world):
    db = np.repeat(cases.make_db(1, seed=11), 2000, axis=0)
    with pytest.raises(ValueError, match="skew"):
        jax_build(db, JCFG, jax_make_mesh(4, 2, 1), slack=1.01)
    msgs = [r["skew"] for r in world[0].result()]
    assert all("skew" in m for m in msgs), msgs


@pytest.mark.parametrize("name,shape,reload_q", cases.COMPACT_RELOADS)
def test_compact_save_load_roundtrip(world, name, shape, reload_q):
    """A save restores onto the same model axes, under the same or another
    query axis; search after load equals the reference's on its own
    build and brute force."""
    db, q = cases.compact_db(name)
    jidx = jax_build(db, JCFG, jax_make_mesh(*shape), slack=2.5)
    got = port_case(world, name)
    assert got["n"] == len(db)
    slices = [r[name] for r in world[0].result()]
    idrows, se = _assemble([s for s in slices if s and s["coords"][2] == 0],
                           shape[0], shape[1])
    assert np.array_equal(idrows, np.asarray(jidx.idrows).view(np.int32))
    assert np.array_equal(se, np.asarray(jidx.se))
    assert_jax(got, jax_search(jidx, q, SCFG))
    assert_oracle(got, db, q, 5)


def test_compact_load_rejects_mismatched_model_mesh(world):
    tmp = tempfile.mkdtemp(prefix="vt_compact_")
    try:
        jax_save(tmp, jax_build(cases.make_db(800, seed=23), JCFG,
                                jax_make_mesh(4, 2, 1), slack=2.5))
        with pytest.raises(ValueError, match="mesh"):
            jax_load(tmp, jax_make_mesh(4, 1, 2))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    msgs = [r["reject"] for r in world[0].result()]
    assert all("mesh" in m for m in msgs), msgs


def test_compact_save_loads_across_packages(world):
    """The reference's save searched by the port, the port's by the
    reference: both equal the reference's search on its own build."""
    db, q = cases.interop_db()
    mesh = jax_make_mesh(4, 2, 1)
    want = jax_search(jax_build(db, JCFG, mesh, slack=2.5), q, SCFG)
    for name in ("from_jax", "port_saved"):
        got = port_case(world, name)
        assert_jax(got, want)
        assert_oracle(got, db, q, 5)
    jidx = jax_load(os.path.join(world[1], "port_saved"), mesh)
    res = jax_search(jidx, q, SCFG)
    assert_jax(port_case(world, "port_saved"), res)
    for f in ("dists", "ids"):
        assert np.array_equal(np.asarray(getattr(res, f)),
                              np.asarray(getattr(want, f))), f


@pytest.mark.skipif(not os.environ.get("VERTICUT_SCALE_TESTS"),
                    reason="10M-row distributed build on the CPU mesh takes "
                           "~10 min in the reference; set "
                           "VERTICUT_SCALE_TESTS=1 to run")
def test_compact_scale_10m_rows():
    """A compact sharded index of 10M clustered codes in a world of 8,
    oracle-verified on 64 queries, with the memory math of the reference's
    scale case."""
    got, stats = spawn(cases.run_compact_scale, 8, device="cpu")[0]
    assert stats["bytes_per_code"] < 60
    db = cases.scale_db()
    ld, _ = linear_search(as_codes(db[:64], "cpu"), as_codes(db, "cpu"), 10,
                          method="popcount")
    assert np.array_equal(got["dists"], ld.numpy())
