"""The port's inline sharded engine against the JAX package's, on the same
meshes as tests/test_sharded.py.

The port runs in one gloo world of 8 CPU processes
(``parallel.world.spawn``; the ranks run ``torch_world_cases.run_sharded``
while this process runs the reference on its 8 virtual CPU devices).
Every case holds (tolerance 0): dists and radius / n_probes / n_nonempty /
n_cands equal to JAX's sharded engine; ids equal to JAX's (both take the
packed selections at these sizes), to the port's single-device range
engine, and to brute force (the ids among the codes at a row's kth
distance may differ from brute force under the reference's stop rule,
ROADMAP.md Queue 3: every returned id is checked at its true distance
instead); and every rank of the mesh returning the same result.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig as JMIHConfig
from verticut_tpu.config import SearchConfig as JSearchConfig
from verticut_tpu.parallel import make_mesh as jax_make_mesh
from verticut_tpu.search import linear_search as jax_linear_search
from verticut_tpu.search.sharded import build_sharded_index as jax_build
from verticut_tpu.search.sharded import sharded_linear_search as jax_lin
from verticut_tpu.search.sharded import sharded_mih_search as jax_search

import torch_world_cases as cases
from benchmark.check import judge
from benchmark.references import hamming_topk
from verticut_tpu_torch.bits import as_codes
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.index.mih import sort_table
from verticut_tpu_torch.parallel.world import spawn
from verticut_tpu_torch.search import linear_search, mih_search

FIELDS = ("dists", "ids", "radius", "n_probes", "n_nonempty", "n_cands")


@pytest.fixture(scope="module")
def world():
    """The port's results, computed in a world of 8 while the tests run
    the reference."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(spawn, cases.run_sharded, 8, device="cpu",
                        threads=1)


def port_case(world, name):
    """The case's result, after checking that every rank of its mesh
    returned the same one."""
    got = [r[name] for r in world.result() if r[name] is not None]
    assert got, name
    for other in got[1:]:
        for f, v in got[0].items():
            assert np.array_equal(other[f], v), (name, f)
    return got[0]


def jax_cfgs(cfg, scfg):
    return (JMIHConfig(bits=cfg.bits, n_tables=cfg.n_tables),
            JSearchConfig(**dataclasses.asdict(scfg)))


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


def assert_single_engine(got, db, q, cfg, scfg):
    """Dists and ids equal to the port's single-device range engine."""
    idx = build_index(db, cfg, directory="range", device="cpu")
    one = mih_search(idx, q, scfg)
    assert np.array_equal(got["dists"], one.dists.numpy())
    assert np.array_equal(got["ids"], one.ids.numpy())


SEARCH_CASES = [c[0] for c in cases.SHARDED_SEARCHES]


@pytest.mark.parametrize("name", SEARCH_CASES)
def test_sharded_search_matches_jax(world, name):
    _, shape, cfg, _, _, scfg = next(c for c in cases.SHARDED_SEARCHES
                                     if c[0] == name)
    db, q = cases.sharded_db(name)
    jcfg, jscfg = jax_cfgs(cfg, scfg)
    want = jax_search(jax_build(db, jcfg, jax_make_mesh(*shape)), q, jscfg)
    got = port_case(world, name)
    for f in FIELDS:
        assert np.array_equal(got[f], np.asarray(getattr(want, f))), f
    if scfg.approximate:
        # every returned id's distance is genuine
        valid = got["ids"] >= 0
        true = np.asarray(jcodes.hamming_distance(
            jnp.asarray(db)[np.clip(got["ids"], 0, None)],
            jnp.asarray(q)[:, None, :]))
        assert np.array_equal(true[valid], got["dists"][valid])
    else:
        assert_oracle(got, db, q, scfg.knn)
        assert_single_engine(got, db, q, cfg, scfg)


@pytest.mark.parametrize("name", ["straddle", "straddle_loop"])
def test_straddling_hot_bucket_across_shards(world, name):
    """One bucket of 600 equal codes straddles the shard boundary; the
    tight cap forces the overflow retries."""
    db, q = cases.hot_db()
    scfg = JSearchConfig(knn=10, candidate_cap=256,
                         fused=name == "straddle")
    want = jax_search(jax_build(db, JMIHConfig(bits=128, n_tables=4),
                                jax_make_mesh(4, 2, 1)), q, scfg)
    got = port_case(world, name)
    for f in FIELDS:
        assert np.array_equal(got[f], np.asarray(getattr(want, f))), f
    assert_oracle(got, db, q, 10)
    assert_single_engine(got, db, q, cases.CFG4, scfg)


def test_loop_driver_matches_fused(world):
    fused, loop = port_case(world, "oracle_421"), port_case(world, "loop_421")
    for f in ("dists", "ids"):
        assert np.array_equal(fused[f], loop[f]), f
    a, b = port_case(world, "approx"), port_case(world, "approx_loop")
    assert np.array_equal(a["dists"], b["dists"])


def test_sharded_rejects_bad_table_axis(world):
    with pytest.raises(ValueError):
        jax_build(cases.make_db(64), JMIHConfig(bits=128, n_tables=4),
                  jax_make_mesh(2, 2, 2))
    msgs = [r["raises_222"] for r in world.result()]
    assert all("mesh table axis 2" in m for m in msgs), msgs


def test_collectives_over_the_plane(world):
    """The counterparts of the reference's collectives over a plane of 8:
    the all-gathers keep rank order ([D, Q, C] -> [Q, D*C]), the reductions
    hold on int32 (gloo reduces neither bool nor uint32), and the bitmap
    OR holds on the sign bit, overlapping or disjoint."""
    got = port_case(world, "collectives")
    assert got["any"].tolist() == [True, False]
    assert got["sum"].tolist() == [28, 8]
    assert int(got["max"]) == 7
    assert got["or"].view(np.uint32).tolist() == [0xFF, 0x80000000, 5]
    assert got["or_disjoint"].view(np.uint32).tolist() == [0xFF, 0x80000000]
    assert got["strips"].tolist() == [list(range(8))] * 2
    assert got["cand_d"].tolist() == [sum([[r] * 3 for r in range(8)], [])] * 2
    assert got["cand_i"].tolist() == [sum([[-r] * 3 for r in range(8)],
                                          [])] * 2


def test_sharded_linear_scan(world):
    db = cases.make_db(333, seed=4)
    got = port_case(world, "linear")
    mesh = jax_make_mesh(4, 2, 1)
    idx = jax_build(db, JMIHConfig(), mesh)
    d, i = jax_lin(mesh, idx.codes, jnp.asarray(db[:8]), 7, n_total=idx.n)
    ed, ei = jax_linear_search(db[:8], db, 7)
    for want_d, want_i in ((d, i), (ed, ei)):
        assert np.array_equal(got["dists"], np.asarray(want_d))
        assert np.array_equal(got["ids"], np.asarray(want_i))


@pytest.mark.parametrize("name", [c[0] for c in cases.BUILDS] + ["single"])
def test_build_is_byte_equal_to_the_plain_build(request, name):
    """Every rank's entry rows, directory and codes slice equal, byte for
    byte, to those of the build before it was cut to fit 1B codes a rank
    (``torch_world_cases.plain_build``); ``single``: the one-card build's
    rows equal to those of ``make_entry_rows`` before it could build a
    slice."""
    if name == "single":
        db = cases.make_db(1001, seed=3)
        idx = build_index(db, cases.CFG4, directory="range",
                          keep_entry_ids=False, device="cpu")
        codes_t = as_codes(db, "cpu")
        for t, table in enumerate(idx.tables):
            want = cases.plain_make_entry_rows(
                sort_table(codes_t, t, cases.CFG4.s_bits)[1], codes_t)
            assert torch.equal(table.entry_rows, want), t
        return
    world = request.getfixturevalue("world")
    got = [r[name] for r in world.result() if r[name] is not None]
    shape = next(c[1] for c in cases.BUILDS if c[0] == name)
    assert len(got) == shape[0] * shape[1] * shape[2]
    for r in got:
        for f in ("entry_rows", "se", "codes"):
            assert r["new"][f].dtype == r["old"][f].dtype, f
            assert np.array_equal(r["new"][f], r["old"][f]), f
        assert r["new"]["n_rows"] == r["old"]["n_rows"]


def wide_results(world):
    got = [r["wide"] for r in world.result() if r["wide"] is not None]
    assert len(got) == 4
    return got


def test_wide_id_strips_hold_to_the_reference(world):
    """At 4x1x1 with the packed selections refused, as 1B codes refuse
    them: both calls' dists and ids against the plain reference
    (``benchmark/references/hamming_topk.py``), ties to the smaller id,
    with the configuration's exception for rows the stop rule finished at
    ``n_tables * (radius + 1)`` as ``benchmark/check.py`` judges them; the
    same answers on every rank."""
    got = wide_results(world)
    db, q = cases.wide_db()
    corpus, queries = as_codes(db, "cpu"), as_codes(q, "cpu")
    k, m = cases.WIDE_SCFG.knn, cases.CFG4.n_tables
    rd, ri = hamming_topk.topk(queries, corpus, k)
    for r in got:
        assert r["packed_calls"] and all(r["packed_calls"])
        for res in (r["first"], r["second"]):
            for f, v in res.items():
                assert np.array_equal(v, got[0]["first"][f]), f
    res = {f: torch.from_numpy(v) for f, v in got[0]["first"].items()}
    true_d = hamming_topk.hamming(corpus[res["ids"].clamp(0).long()],
                                  queries[:, None, :])
    boundary = res["dists"][:, k - 1] == m * (res["radius"] + 1)
    for j in range(queries.shape[0]):
        assert judge(res["dists"][j], res["ids"][j], rd[j], ri[j], true_d[j],
                     corpus.shape[0], bool(boundary[j])) is None, j
    # the uniform rows reach past the radius step
    assert (res["dists"][cases.WIDE_NEAR:, k - 1]
            > m * (res["radius"][cases.WIDE_NEAR:] + 1)).any()


def test_sharded_spans_and_counters(world):
    """The counters of two calls: one sharded batch and its queries a
    call, the same collectives and bytes on every rank; the spans of the
    sharded path under a CPU profiler."""
    got = wide_results(world)
    nq = cases.WIDE_NEAR + cases.WIDE_FAR
    for r in got:
        c = r["counters"]
        assert c["mih.sharded_batches"] == 2
        assert c["mih.sharded_queries"] == 2 * nq
        assert c["coll.calls"] == got[0]["counters"]["coll.calls"] > 2
        assert c["coll.bytes"] == got[0]["counters"]["coll.bytes"] > 0
        assert r["spans"] == sorted(cases.SHARDED_SPANS)


@pytest.mark.slow
def test_sharded_scale_1m_rows():
    """~1M clustered codes on a (4, 2, 1) world: realistic shard
    boundaries, capacity math and collective shapes."""
    from verticut_tpu_torch.parallel.world import spawn as spawn_world
    db = jcodes.clustered_codes(13, 1_000_000, 128, n_clusters=5000,
                                flip_p=0.02)
    q = cases.flipped_rows(db, 64, 3)
    got = spawn_world(cases.run_sharded_scale, 8, db, q, device="cpu")[0]
    scfg = JSearchConfig(knn=10)
    want = jax_search(jax_build(db, JMIHConfig(bits=128, n_tables=4),
                                jax_make_mesh(4, 2, 1)), q, scfg)
    for f in FIELDS:
        assert np.array_equal(got[f], np.asarray(getattr(want, f))), f
    assert_oracle(got, db, q, 10)
