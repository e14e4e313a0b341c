"""The port's mih_search against the JAX package's mih_search, the slice
as a whole: the fused and the loop driver, exact and approximate mode.
Equal dists, ids, radius, n_probes, n_nonempty and n_cands (tolerance 0)
on the same corpus, index and queries."""

import dataclasses
import itertools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index as jax_build_index
from verticut_tpu.search import linear_search as jax_linear_search
from verticut_tpu.search import mih_search as jax_mih_search
from verticut_tpu.search import mih_search_dispatch as jax_dispatch
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                       mih_search_finalize)
import verticut_tpu_torch.search.single as single

N = 200_000
CFG = MIHConfig(bits=128, n_tables=4)
FIELDS = ("dists", "ids", "radius", "n_probes", "n_nonempty", "n_cands")


def _perturbed(packed, nq, seed):
    """Random corpus rows with 3 random bit flips each (as bench.py)."""
    rng = np.random.default_rng(seed)
    q = packed[rng.integers(0, len(packed), nq)].copy()
    pos = rng.integers(0, 128, (nq, 3))
    for j in range(3):
        np.bitwise_xor.at(q, (np.arange(nq), pos[:, j] // 32),
                          np.uint32(1) << (pos[:, j] % 32).astype(np.uint32))
    return q


def _assert_parity(port_index, jax_index, queries, scfg, rows=slice(None)):
    got = mih_search(port_index, queries, scfg)
    want = jax_mih_search(jax_index, queries, scfg)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy()[rows],
                              np.asarray(getattr(want, f))[rows]), f
    return got, want


@pytest.fixture(scope="module")
def clustered():
    packed = jcodes.clustered_codes(0, N, 128, n_clusters=N // 200,
                                    flip_p=0.02)
    return (packed, build_index(packed, CFG, device="cpu"),
            jax_build_index(packed, CFG, directory="range"))


@pytest.mark.parametrize("uniform,nq,k", [(False, 64, 10), (False, 64, 100),
                                          (False, 2048, 10),
                                          (True, 1024, 10)])
def test_mih_search_matches_jax(clustered, uniform, nq, k):
    packed, port_index, jax_index = clustered
    q = (jcodes.random_codes(99, nq, 128) if uniform
         else _perturbed(packed, nq, seed=nq + k))
    scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
    got, _ = _assert_parity(port_index, jax_index, q, scfg)
    if uniform:
        # the dominance gate skipped every stage after the first and the
        # scan ladder resolved the whole batch
        assert (got.radius == 1).all()
    else:
        assert (got.dists[:, 0] <= 3).all()         # planted neighbour


def test_overflow_retry_ladders_match_jax(monkeypatch):
    """A heavily clustered corpus and a small candidate_cap overflow the
    stage budgets: the device retry ladder runs, and rows it cannot fix
    take the 4x-cap host retry."""
    packed = jcodes.clustered_codes(1, N, 128, n_clusters=50, flip_p=0.02)
    q = _perturbed(packed, 64, seed=5)
    scfg = SearchConfig(knn=10, candidate_cap=2000, max_enum_radius=5)
    calls = {"states": 0, "retries": 0}
    init_state, search = single.init_state, single.mih_search

    def count_states(*a, **kw):
        calls["states"] += 1
        return init_state(*a, **kw)

    def count_retries(index, queries, scfg, _cap=None):
        calls["retries"] += _cap is not None
        return search(index, queries, scfg, _cap)

    monkeypatch.setattr(single, "init_state", count_states)
    monkeypatch.setattr(single, "mih_search", count_retries)
    _assert_parity(build_index(packed, CFG, device="cpu"),
                   jax_build_index(packed, CFG, directory="range"), q, scfg)
    assert calls["retries"] >= 1
    # the top call's state, its retry ladder's, and each host retry's
    assert calls["states"] >= 2 + calls["retries"]


@pytest.mark.parametrize("n,n_tables,k,approx", [
    (500, 4, 10, False),
    (400, 16, 5, False),
    (600, 4, 5, True),
])
@pytest.mark.parametrize("fused", [False, True])
def test_drivers_match_jax_small(n, n_tables, k, approx, fused):
    """The cases of the JAX package's fused-equals-loop test, each driver
    against the JAX driver of the same flags, on both packages' default
    builds (range at 4 tables, dense at 16)."""
    rng = np.random.default_rng(n + k)
    packed = jcodes.pack_bytes(
        rng.integers(0, 256, size=(n, 16), dtype=np.uint8))
    cfg = MIHConfig(bits=128, n_tables=n_tables)
    scfg = SearchConfig(knn=k, approximate=approx, approximate_factor=4,
                        candidate_cap=1024, fused=fused)
    port = build_index(packed, cfg, device="cpu")
    assert port.is_range == (n_tables == 4)
    _assert_parity(port, jax_build_index(packed, cfg), packed[:32], scfg)


@pytest.mark.parametrize("k", [10, 100])
def test_loop_driver_matches_jax(clustered, k):
    packed, port_index, jax_index = clustered
    q = _perturbed(packed, 64, seed=64 + k)
    scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5,
                        fused=False)
    got, _ = _assert_parity(port_index, jax_index, q, scfg)
    fused = mih_search(port_index, q, dataclasses.replace(scfg, fused=True))
    for f in FIELDS:                      # below SCAN_DOMINANCE_MIN_NQ
        assert np.array_equal(getattr(got, f).numpy(),
                              getattr(fused, f).numpy()), f


def test_loop_driver_compacts_twice(clustered):
    """At 2048 queries the loop driver compacts the batch twice (to 512
    rows, then to 64), and the second compaction retires pad rows. The
    JAX loop driver then writes a pad row over its last query's result
    (ROADMAP.md Queue 3): the port equals it on every other row, and
    equals brute force on the last 64."""
    packed, port_index, jax_index = clustered
    q = _perturbed(packed, 2048, seed=4)
    scfg = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5,
                        fused=False)
    got, want = _assert_parity(port_index, jax_index, q, scfg,
                               rows=slice(0, -1))
    od, oi = jax_linear_search(q[-64:], packed, 10)
    assert np.array_equal(got.dists[-64:].numpy(), np.asarray(od))
    assert np.array_equal(got.ids[-64:].numpy(), np.asarray(oi))
    assert not np.array_equal(np.asarray(want.dists)[-1], np.asarray(od)[-1])
    assert (got.radius.numpy() >= 1).all() and (got.radius == 3).any()


@pytest.mark.parametrize("fused", [False, True])
def test_approximate_matches_jax_at_production_shape(fused):
    """The JAX package's approximate-mode test shape: 60k codes, 48
    queries two bit flips from a corpus row, k = 10, a k * 20 pool."""
    rng = np.random.default_rng(42)
    n, nq = 60_000, 48
    raw_db = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    raw_q = raw_db[rng.integers(0, n, nq)].copy()
    for i in range(nq):
        for b in rng.integers(0, 128, 2):
            raw_q[i, b // 8] ^= np.uint8(1 << (b % 8))
    packed = jcodes.pack_bytes(raw_db)
    scfg = SearchConfig(knn=10, approximate=True, candidate_cap=8192,
                        fused=fused)
    got, _ = _assert_parity(build_index(packed, CFG, device="cpu"),
                            jax_build_index(packed, CFG, directory="range"),
                            jcodes.pack_bytes(raw_q), scfg)
    assert (got.radius <= 3).all() and (got.ids >= 0).all()


def test_empty_fused_schedule_runs_the_loop_driver(monkeypatch):
    """fused_max_masks=0 admits no radius stage: the fused request falls
    through to the loop driver, as in the reference."""
    rng = np.random.default_rng(1)
    packed = jcodes.pack_bytes(
        rng.integers(0, 256, size=(3000, 16), dtype=np.uint8))
    calls = []
    loop = single._mih_search_loop

    def spy(*a, **kw):
        calls.append(1)
        return loop(*a, **kw)

    monkeypatch.setattr(single, "_mih_search_loop", spy)
    _assert_parity(build_index(packed, CFG, device="cpu"),
                   jax_build_index(packed, CFG, directory="range"),
                   packed[:40], SearchConfig(knn=10, fused_max_masks=0))
    assert calls


def test_unported_options_raise():
    """What raises: a bitmap request on the range engine (as in the JAX
    package, which raises for it too), queries of another width, and a
    compact layout without its codes."""
    packed = jcodes.random_codes(3, 500, 128)
    index = build_index(packed, CFG, device="cpu")
    q = packed[:4]
    with pytest.raises(ValueError, match="use_bitmap"):
        mih_search(index, q, SearchConfig(use_bitmap=True))
    with pytest.raises(ValueError, match="use_bitmap"):
        mih_search_dispatch(index, q, SearchConfig(use_bitmap=True))
    with pytest.raises(ValueError, match="use_bitmap"):
        jax_mih_search(jax_build_index(packed, CFG, directory="range"), q,
                       SearchConfig(use_bitmap=True))
    with pytest.raises(ValueError, match="code width"):
        mih_search(index, q[:, :2], SearchConfig())
    with pytest.raises(ValueError, match="compact"):
        build_index(packed, CFG, device="cpu", store_codes=False,
                    keep_codes=False)
    # past the crossover an approximate request runs the exact engine
    r = mih_search(index, q, SearchConfig(knn=60, approximate=True))
    e = mih_search(index, q, SearchConfig(knn=60))
    assert np.array_equal(r.dists.numpy(), e.dists.numpy())
    # the fused driver declines a loop request and an empty schedule
    assert mih_search_dispatch(index, q, SearchConfig(fused=False)) is None
    assert mih_search_dispatch(index, q,
                               SearchConfig(fused_max_masks=0)) is None


#: bucket engines: (directory, tables, bitmap built and used, entry codes)
BUCKETS = [("auto", 8, False, True), ("auto", 8, True, False),
           ("sorted", 4, False, True), ("prefix", 4, False, False),
           ("hash", 4, False, True), ("hash", 8, True, True)]


@pytest.fixture(scope="module")
def bucket_corpus():
    """6000 clustered codes, every substring crossing 2^31 in some rows;
    48 perturbed and 16 uniform queries."""
    packed = jcodes.clustered_codes(12, 6000, 128, n_clusters=30,
                                    flip_p=0.03)
    packed[:300] ^= np.uint32(0x80808080)
    q = np.concatenate([_perturbed(packed, 48, seed=3),
                        jcodes.random_codes(13, 16, 128)])
    return packed, q


@pytest.mark.parametrize("directory,m,bitmap,store_codes", BUCKETS)
@pytest.mark.parametrize("fused", [True, False])
def test_bucket_engines_match_jax(bucket_corpus, directory, m, bitmap,
                                  store_codes, fused):
    """The bucket engines (dense with and without the bitmap, sorted,
    prefix, hash) under each driver, exact and approximate, bit-equal to
    the JAX package in dists, ids and the four stats; the exact answers
    equal brute force in dists. The exact search's candidate cap of 512 overflows
    the clustered 16-bit buckets of the 8-table indexes, so the overflow
    paths run there too."""
    packed, q = bucket_corpus
    cfg = MIHConfig(bits=128, n_tables=m)
    kw = dict(directory=directory, with_bitmap=bitmap,
              store_codes=store_codes)
    port = build_index(packed, cfg, device="cpu", **kw)
    ref = jax_build_index(packed, cfg, **kw)
    assert not port.is_range
    exact = SearchConfig(knn=10, candidate_cap=512, use_bitmap=bitmap,
                         fused=fused)
    got, _ = _assert_parity(port, ref, q, exact)
    od, oi = jax_linear_search(q, packed, 10, method="popcount")
    assert np.array_equal(got.dists.numpy(), np.asarray(od))
    # ids too, but for the codes at a row's kth distance: the stop rule
    # (kth distance at most (radius + 1) * m) may stop before it has seen
    # every code at that distance (ROADMAP.md Queue 3)
    assert ((got.ids.numpy() == np.asarray(oi))
            | (got.dists.numpy() == got.dists.numpy()[:, -1:])).all()
    _assert_parity(port, ref, q, SearchConfig(
        knn=5, approximate=True, approximate_factor=4, use_bitmap=bitmap,
        fused=fused))


@pytest.mark.parametrize("bits_w,n_tables", [(64, 2), (256, 8)])
def test_code_widths_match_jax(bits_w, n_tables):
    """64- and 256-bit codes under uniform queries: stage 0, then the scan
    tier for the whole batch (on a card, blockmin's tensor-core instance
    at W = 2 and 8).
    At 256 bits both packages take the wide-id selections at any n."""
    packed = jcodes.clustered_codes(1, 20_000, bits_w, n_clusters=100,
                                    flip_p=0.02)
    cfg = MIHConfig(bits=bits_w, n_tables=n_tables)
    q = jcodes.random_codes(5, 1024, bits_w)
    got, _ = _assert_parity(build_index(packed, cfg, device="cpu"),
                            jax_build_index(packed, cfg, directory="range"),
                            q, SearchConfig(knn=10))
    assert (got.radius == 1).all()


def _widen(index, n_entries, zeros):
    """Give every table one flat id column of ``n_entries`` entries: the
    drivers then size ids past 2^24 (the range engine reads its ids from
    the entry rows, so the answers do not change)."""
    index.tables = [t._replace(entry_ids=zeros(n_entries))
                    for t in index.tables]
    return index


WIDE = 2 ** 24 + 2


@pytest.fixture(scope="module")
def wide(clustered):
    """The 200k corpus in both packages with ids sized past 2^24."""
    import jax.numpy as jnp
    import torch
    packed, _, _ = clustered
    return (packed,
            _widen(build_index(packed, CFG, device="cpu"), WIDE,
                   lambda n: torch.zeros(n, dtype=torch.int32)),
            _widen(jax_build_index(packed, CFG, directory="range"), WIDE,
                   lambda n: jnp.zeros(n, jnp.int32)))


@pytest.mark.parametrize("nq,k", [(64, 10), (64, 100), (2048, 10)])
def test_wide_ids_match_jax_and_the_packed_branch(clustered, wide, nq, k):
    """Past 2^24 ids every radius step takes the _pos selections and the
    result row the [Q, 2k + 3] layout, in both packages. The port equals
    its packed-branch run (itself equal to the JAX packed run, above) in
    dists, ids and the four stats, and the JAX wide run in dists and the
    four stats. The JAX wide run keeps a table's first slots at an equal
    distance, not its smallest ids (ROADMAP.md Queue 3), so its ids may
    differ at the kth-distance ties; the port's equal brute force."""
    packed, port_packed, _ = clustered
    _, port_wide, jax_wide = wide
    q = _perturbed(packed, nq, seed=nq + k)
    scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
    assert mih_search_dispatch(port_wide, q, scfg).packed.shape == (
        nq, 2 * k + 3)
    got = mih_search(port_wide, q, scfg)
    base = mih_search(port_packed, q, scfg)
    want = jax_mih_search(jax_wide, q, scfg)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              getattr(base, f).numpy()), f
        if f != "ids":
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
    od, oi = jax_linear_search(q[:64], packed, k, method="popcount")
    assert np.array_equal(got.ids[:64].numpy(), np.asarray(oi))


@pytest.mark.parametrize("wide_ids", [False, True])
def test_dispatch_row_matches_jax(wide_ids):
    """The packed result row itself, bit for bit: [Q, k + 3] packed pairs,
    or [Q, 2k + 3] past 2^24 ids. Uniform queries against a uniform corpus
    resolve in the exact scan tier, where both packages order ties by id."""
    import jax.numpy as jnp
    import torch
    packed = jcodes.random_codes(8, 20_000, 128)
    port = build_index(packed, CFG, device="cpu")
    ref = jax_build_index(packed, CFG, directory="range")
    if wide_ids:
        _widen(port, WIDE, lambda n: torch.zeros(n, dtype=torch.int32))
        _widen(ref, WIDE, lambda n: jnp.zeros(n, jnp.int32))
    q = np.concatenate([packed[:40] ^ np.uint32(6),
                        jcodes.random_codes(9, 40, 128)])
    for k in (7, 30):
        scfg = SearchConfig(knn=k)
        h = mih_search_dispatch(port, q, scfg)
        jh = jax_dispatch(ref, q, scfg)
        assert h.event is None and h.host is h.packed
        want = np.asarray(jh.packed)
        assert h.packed.shape == (80, 2 * k + 3 if wide_ids else k + 3)
        assert np.array_equal(h.packed.numpy().view(want.dtype), want)


def test_dispatch_finalize_out_of_order_matches_jax():
    """The JAX package's pipelining test: two handles in flight, finalized
    out of order, each equal to the synchronous search and to JAX."""
    rng = np.random.default_rng(42)
    packed = jcodes.pack_bytes(
        rng.integers(0, 256, size=(2000, 16), dtype=np.uint8))
    index = build_index(packed, CFG, device="cpu")
    q = packed[:64]
    scfg = SearchConfig(knn=7)
    sync = mih_search(index, q, scfg)
    h1 = mih_search_dispatch(index, q, scfg)
    h2 = mih_search_dispatch(index, q[::-1].copy(), scfg)
    r2 = mih_search_finalize(h2)
    r1 = mih_search_finalize(h1)
    want = jax_mih_search(jax_build_index(packed, CFG, directory="range"),
                          q, scfg)
    for f in FIELDS:
        assert np.array_equal(getattr(r1, f).numpy(),
                              getattr(sync, f).numpy()), f
        assert np.array_equal(getattr(r2, f).numpy(),
                              getattr(sync, f).numpy()[::-1]), f
        assert np.array_equal(getattr(r1, f).numpy(),
                              np.asarray(getattr(want, f))), f


@pytest.fixture(scope="module")
def small():
    """2000 uniform codes in both packages, 64 queries at k = 7."""
    rng = np.random.default_rng(42)
    packed = jcodes.pack_bytes(
        rng.integers(0, 256, size=(2000, 16), dtype=np.uint8))
    q = packed[:64] ^ np.uint32(3)
    return (build_index(packed, CFG, device="cpu"), q, SearchConfig(knn=7),
            jax_mih_search(jax_build_index(packed, CFG, directory="range"),
                           q, SearchConfig(knn=7)))


def _assert_equal_results(got, want):
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f


def test_dispatch_returns_while_the_pipeline_is_blocked(small, monkeypatch):
    """dispatch hands the pipeline to a worker and returns at once: here
    the pipeline is held on an event, and dispatch returns all the same;
    once released, finalize equals mih_search and JAX."""
    index, q, scfg, want = small
    started, release = threading.Event(), threading.Event()
    fused_row = single._fused_row

    def blocked(*a, **kw):
        started.set()
        if not release.wait(timeout=60):
            raise TimeoutError("never released")
        return fused_row(*a, **kw)

    monkeypatch.setattr(single, "_fused_row", blocked)
    h = mih_search_dispatch(index, q, scfg)
    try:
        assert started.wait(timeout=60)
        assert not h.future.done() and not release.is_set()
    finally:
        release.set()          # a failed check must not hold the worker
    got = mih_search_finalize(h)
    monkeypatch.setattr(single, "_fused_row", fused_row)
    _assert_equal_results(got, want)
    _assert_equal_results(got, mih_search(index, q, scfg))


def test_dispatch_worker_error_surfaces_from_finalize(small, monkeypatch):
    """An exception in the worker is raised by finalize (and by the
    handle's fields) with its own type; dispatch itself does not raise."""
    index, q, scfg, _ = small

    def boom(*a, **kw):
        raise KeyError("injected pipeline failure")

    monkeypatch.setattr(single, "_fused_row", boom)
    h = mih_search_dispatch(index, q, scfg)
    with pytest.raises(KeyError, match="injected"):
        mih_search_finalize(h)
    with pytest.raises(KeyError):
        h.packed


def test_second_dispatch_queues_behind_the_first(small, monkeypatch):
    """A device runs one pipeline at a time: a second dispatch returns at
    once, and its pipeline starts only when the first one has finished."""
    index, q, scfg, want = small
    log, a_runs, release = [], threading.Event(), threading.Event()
    fused_row = single._fused_row

    def traced(index, queries, *a):
        name = "A" if queries.shape[0] == 64 else "B"
        log.append(f"{name} runs")
        if name == "A":
            a_runs.set()
            if not release.wait(timeout=60):
                raise TimeoutError("never released")
        out = fused_row(index, queries, *a)
        log.append(f"{name} ends")
        return out

    monkeypatch.setattr(single, "_fused_row", traced)
    h_a = mih_search_dispatch(index, q, scfg)
    try:
        assert a_runs.wait(timeout=60)
        h_b = mih_search_dispatch(index, q[:40], scfg)
        time.sleep(0.2)            # B would start here if it did not queue
        assert log == ["A runs"] and not h_b.future.done()
    finally:
        release.set()          # a failed check must not hold the worker
    got = mih_search_finalize(h_b), mih_search_finalize(h_a)
    monkeypatch.setattr(single, "_fused_row", fused_row)
    assert log == ["A runs", "A ends", "B runs", "B ends"]
    _assert_equal_results(got[1], want)
    _assert_equal_results(got[0], mih_search(index, q[:40], scfg))


@pytest.mark.parametrize("order", list(itertools.permutations(range(3))))
def test_three_dispatches_finalized_in_any_order(small, order):
    """Three handles in flight (one runs, two queue behind it), each
    with its own batch, finalized in every order: each equals its
    synchronous search, and the first equals JAX."""
    index, q, scfg, want = small
    batches = [q, q[::-1].copy(), q[:40]]
    handles = [mih_search_dispatch(index, b, scfg) for b in batches]
    got = {i: mih_search_finalize(handles[i]) for i in order}
    _assert_equal_results(got[0], want)
    for i, b in enumerate(batches):
        _assert_equal_results(got[i], mih_search(index, b, scfg))


@pytest.mark.parametrize("fused", [True, False])
def test_overflow_to_scan_matches_jax(monkeypatch, fused):
    """The JAX package's merged-ladder test: tiny caps overflow nearly
    every query; with overflow_to_scan the fused driver sends them to the
    scan ladder instead of the retry ladder (the loop driver has no scan
    ladder and ignores the flag). Equal to JAX and to brute force."""
    rng = np.random.default_rng(8)
    n, nq, k = 6_000, 64, 10
    raw = rng.integers(0, 4, (n, 16), dtype=np.uint8) * 64
    packed = jcodes.pack_bytes(raw)
    scfg = SearchConfig(knn=k, candidate_cap=256, overflow_to_scan=True,
                        fused=fused)
    states = []
    init_state = single.init_state

    def count_states(n_queries, *a, **kw):
        states.append(n_queries)
        return init_state(n_queries, *a, **kw)

    monkeypatch.setattr(single, "init_state", count_states)
    got, _ = _assert_parity(build_index(packed, CFG, device="cpu"),
                            jax_build_index(packed, CFG, directory="range"),
                            packed[:nq], scfg)
    od, oi = jax_linear_search(packed[:nq], packed, k, method="popcount")
    assert np.array_equal(got.dists.numpy(), np.asarray(od))
    assert np.array_equal(got.ids.numpy(), np.asarray(oi))
    if fused:        # one state for the batch, none for a retry ladder
        assert states == [nq]


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import verticut_tpu_torch, verticut_tpu_torch.index, "
        "verticut_tpu_torch.search, verticut_tpu_torch.ops.hamming, "
        "verticut_tpu_torch.kernels.blockmin, "
        "verticut_tpu_torch.kernels.pairwise, verticut_tpu_torch.bench, "
        "verticut_tpu_torch.oracle_drive, "
        "verticut_tpu_torch.index.integrity, verticut_tpu_torch.breakdown, "
        "verticut_tpu_torch.service, verticut_tpu_torch.service.wire, "
        "verticut_tpu_torch.utils, "
        "verticut_tpu_torch.tools.image_server, "
        "verticut_tpu_torch.tools.image_search_test\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'verticut_tpu', 'msgpack')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The tier plans of the benchmark cells' shapes (8,192-query batches, the
# reference bench's settings), of one approximate batch and of one that
# sends its overflow to the scan tier: the stages, caps and run_pipeline
# keywords each engine's fused driver planned before the plan had one
# home (single._fused_row, and sharded._fused_budgets at a rank's slice).
# Cases: (n, fetch block, prefix bits, config, stages and plan).
_BLK = 25         # inline rows of 128-bit codes (entry_block_size(4))
_STAGES = ((1, (0, 1)), (2, (2,)))
TIER_PLANS = {
    "100m-neardup-k10": (100_000_000, _BLK, 24, dict(knn=10), dict(
        schedule=_STAGES, caps=(1300, 8192), batch_caps=(8192, 512),
        retry_caps=(2600, 8192), retry_budget=2048, scan_dominance=4096,
        overflow_to_scan=False)),
    "100m-neardup-k100": (100_000_000, _BLK, 24, dict(knn=100), dict(
        schedule=_STAGES, caps=(1300, 8192), batch_caps=(8192, 2048),
        retry_caps=(2600, 8192), retry_budget=2048, scan_dominance=4096,
        overflow_to_scan=False)),
    "100m-uniform-k10": (100_000_000, _BLK, 24, dict(knn=10), dict(
        schedule=_STAGES, caps=(1300, 8192), batch_caps=(8192, 512),
        retry_caps=(2600, 8192), retry_budget=2048, scan_dominance=4096,
        overflow_to_scan=False)),
    "1b-compact-k10": (1_000_000_000, 32, 24, dict(knn=10), dict(
        schedule=_STAGES, caps=(4224, 8192), batch_caps=(8192, 512),
        retry_caps=(8192, 8192), retry_budget=2048, scan_dominance=4096,
        overflow_to_scan=False)),
    "1b-four-card-rank-slice": (1_000_000_000, _BLK, 24, dict(knn=10), dict(
        schedule=_STAGES, caps=(4000, 8192), batch_caps=(8192, 512),
        retry_caps=(8000, 8192), retry_budget=2048, scan_dominance=4096,
        overflow_to_scan=False)),
    "100m-approximate": (100_000_000, _BLK, 24,
                         dict(knn=10, approximate=True), dict(
        schedule=((0, (0,)), (1, (1,)), (2, (2,))), caps=(400, 1200, 8192),
        batch_caps=(8192, 512, 128), retry_caps=(800, 2400, 8192),
        retry_budget=2048, scan_dominance=0, overflow_to_scan=False)),
    "20m-overflow-to-scan": (20_000_000, _BLK, 22,
                             dict(knn=10, overflow_to_scan=True), dict(
        schedule=_STAGES, caps=(1100, 8192), batch_caps=(8192, 512),
        retry_caps=None, retry_budget=0, scan_dominance=4096,
        overflow_to_scan=True)),
}


@pytest.mark.parametrize("case", list(TIER_PLANS))
def test_tier_plan_of_the_cells(case):
    from verticut_tpu_torch import config as tconfig
    from verticut_tpu_torch.index.directory import pick_range_pbits
    from verticut_tpu_torch.ops import enumeration
    n, blk, pbits, kw, want = TIER_PLANS[case]
    cfg = tconfig.MIHConfig(bits=128, n_tables=4)
    scfg = single.effective_scfg(tconfig.SearchConfig(
        candidate_cap=8192, max_enum_radius=5, **kw))
    assert pick_range_pbits(n, cfg.s_bits, blk) == pbits
    schedule, masks, caps = single.range_stages(scfg, cfg, n, pbits, blk,
                                                "cpu", fused=True)
    assert [m.shape[0] for m in masks] == [
        sum(enumeration.n_masks(pbits, r) for r in g)
        for _, g in schedule]
    got = single.tier_plan(scfg, n, 8192, schedule, caps, scan=True)
    assert dict(schedule=schedule, caps=caps, **got) == want


@pytest.mark.parametrize("base_cap, n, rerun_cap, scanned", [
    (100, 1000, 400, [2, 3]),       # overflowed row 1 re-runs at 4x
    (300, 1000, 1000, [2, 3]),      # ... held to n
    (1000, 1000, None, [1, 2, 3]),  # the cap covers n: row 1 is unfinished
])
def test_the_host_finish_reruns_overflow_and_scans_unfinished_rows(
        base_cap, n, rerun_cap, scanned):
    """``apply_fallbacks`` with a fake re-run and scan: an overflowed
    finished row re-runs at 4x the cap while the cap is below n, and
    counts as unfinished once it covers n; unfinished rows (an overflowed
    one among them) take the scan; the read-amplification stats stay the
    first run's, and every row re-run or scanned is counted."""
    from verticut_tpu_torch.utils import timer
    nq, k = 6, 2
    t = torch.tensor
    overflow = t([False, True, False, True, False, False])
    not_done = t([False, False, True, True, False, False])
    stats = [torch.arange(nq, dtype=torch.int32) + s for s in (10, 20, 30)]
    calls = []

    def rerun(idxs, cap):
        calls.append(("rerun", idxs.tolist(), cap))
        m = idxs.shape[0]
        return (torch.full((m, k), 7, dtype=torch.int32),
                idxs[:, None].repeat(1, k).int() + 100,
                torch.full((m,), 9, dtype=torch.int32))

    def scan(idxs):
        calls.append(("scan", idxs.tolist()))
        m = idxs.shape[0]
        return (torch.full((m, k), 5, dtype=torch.int32),
                idxs[:, None].repeat(1, k).int() + 200)

    before = timer.counters()
    res = single.apply_fallbacks(
        rerun, scan, n=n, base_cap=base_cap,
        dists=torch.zeros(nq, k, dtype=torch.int32),
        ids=torch.zeros(nq, k, dtype=torch.int32),
        radius=torch.ones(nq, dtype=torch.int32), overflow=overflow,
        not_done=not_done, n_probes=stats[0], n_nonempty=stats[1],
        n_cands=stats[2])
    c = timer.counters(since=before)
    reran = [1] if rerun_cap else []
    assert calls == ([("rerun", reran, rerun_cap)] if reran else []) + [
        ("scan", scanned)]
    assert c["mih.fallback_rows"] == len(reran) + len(scanned)
    want_d = torch.zeros(nq, k, dtype=torch.int32)
    want_i = torch.zeros(nq, k, dtype=torch.int32)
    want_r = torch.ones(nq, dtype=torch.int32)
    for i in reran:
        want_d[i], want_i[i], want_r[i] = 7, 100 + i, 9
    for i in scanned:
        want_d[i], want_i[i] = 5, 200 + i
    assert torch.equal(res.dists, want_d) and torch.equal(res.ids, want_i)
    assert torch.equal(res.radius, want_r)
    for got, want in zip((res.n_probes, res.n_nonempty, res.n_cands), stats):
        assert torch.equal(got, want)
