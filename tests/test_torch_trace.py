"""The port's spans and counters (``utils/timer.py``) and the chip tools'
split of a profile by span (``breakdown.span_split``), on the CPU: spans
cost nothing and call no ``record_function`` while no profiler records;
under a profiler the fused search path records its spans, each nested
where it was caused; the counters add up what the path ran; answers do
not change with a profiler recording; the server reports the counters;
the split leaves spans' device records out of the kernels and gives each
kernel to every span around its launch."""

import re

import numpy as np
import pytest
import torch

from verticut_tpu_torch import bench, breakdown, codes
from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.kernels import blockmin
from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                       mih_search_finalize, single)
from verticut_tpu_torch.utils import timer

CPU = torch.device("cpu")
#: every span the fused search path may record
SPANS = {"mih.dispatch", "mih.pipeline", "mih.lookup", "mih.fetch_score",
         "mih.strip", "mih.merge", "mih.gate", "mih.compact", "mih.retry",
         "mih.scan", "scan.select", "scan.rescore", "mih.pack",
         "mih.finalize"}
STEP = re.compile(r"mih\.step\.r\d+")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    return bench.make_index(3000, CPU)[0]


def neardup(index, q, seed=0):
    return bench.perturbed_queries(np.random.default_rng(seed), index.codes,
                                   q)


def uniform(q, seed=1):
    return bits_lib.as_codes(codes.random_codes(seed, q, 128), CPU)


def profiled(fn):
    """``fn()`` under a CPU profiler recording every thread: ``(result,
    kineto events)``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            **breakdown._all_threads()) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def spans_of(events):
    return [(e.name(), e.start_thread_id(), e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in events
            if e.name().startswith(breakdown.SPAN_PREFIXES)
            or e.name() == "probe"]


def test_span_is_a_shared_noop_while_nothing_records(monkeypatch, index):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert timer.span("a") is timer.span("b")
    with timer.span("a"):
        pass
    # the whole fused path, its scan tier, and the path fused=False takes
    scfg = SearchConfig(knn=5, max_enum_radius=1)
    mih_search_finalize(mih_search_dispatch(index, uniform(64), scfg))
    mih_search(index, neardup(index, 32), SearchConfig(fused=False))


@pytest.mark.parametrize("queries,scfg", [
    ("neardup", SearchConfig(knn=10)),
    ("uniform", SearchConfig(knn=5, max_enum_radius=1))],
    ids=["neardup", "stragglers"])
def test_the_fused_path_records_its_spans_nested(index, queries, scfg):
    q = neardup(index, 256) if queries == "neardup" else uniform(256)

    def search():
        # marks the caller's thread
        with torch.autograd.profiler.record_function("probe"):
            return mih_search_finalize(mih_search_dispatch(index, q, scfg))

    _, events = profiled(search)
    spans = spans_of(events)
    names = {n for n, *_ in spans}
    # operator-scope ranges: no user annotation, so on a card the profiler
    # leaves no device record of a span
    assert not any(e.is_user_annotation() for e in events
                   if e.name().startswith(breakdown.SPAN_PREFIXES))
    assert names - SPANS == {n for n in names if STEP.fullmatch(n)} | {
        "probe"}
    want = {"mih.dispatch", "mih.pipeline", "mih.lookup", "mih.fetch_score",
            "mih.strip", "mih.merge", "mih.gate", "mih.scan", "mih.pack",
            "mih.finalize"}
    if queries == "uniform":
        want |= {"scan.select", "scan.rescore"}
    assert want <= names and any(STEP.fullmatch(n) for n in names)
    (pipe,) = [s for s in spans if s[0] == "mih.pipeline"]
    (probe,) = [s for s in spans if s[0] == "probe"]
    for name, tid, s, e in spans:
        if STEP.fullmatch(name) or name.startswith(("mih.lookup", "mih.scan",
                                                    "mih.pack", "scan.")):
            assert tid == pipe[1] and pipe[2] <= s and e <= pipe[3], name
    # dispatch and finalize on the caller's thread, not the worker's
    for name in ("mih.dispatch", "mih.finalize"):
        (x,) = [s for s in spans if s[0] == name]
        assert x[1] == probe[1] != pipe[1]


def counted(fn):
    before = timer.counters()
    out = fn()
    return out, timer.counters(since=before)


def test_counters_count_batches_and_queries(index):
    scfg = SearchConfig(knn=10)
    qs = [neardup(index, 96, seed) for seed in range(3)]
    _, c = counted(lambda: [mih_search_finalize(h) for h in [
        mih_search_dispatch(index, q, scfg) for q in qs]])
    assert c["mih.batches"] == 3 and c["mih.queries"] == 3 * 96
    assert c["mih.queue_wait_us"] >= 0
    # the first stage runs on every row
    assert sum(v for k, v in c.items()
               if k.startswith("mih.stage_rows.")) >= 3 * 96


def test_fallback_reruns_add_their_work_and_no_batch(index):
    # a cap this small overflows rows past the retry ladder, and the
    # finalize re-runs them through a pipeline of their own
    q = neardup(index, 96)
    _, c = counted(lambda: mih_search_finalize(mih_search_dispatch(
        index, q, SearchConfig(knn=10, candidate_cap=64))))
    assert c["mih.fallback_rows"] > 0
    assert c["mih.batches"] == 1 and c["mih.queries"] == 96
    assert sum(v for k, v in c.items()
               if k.startswith("mih.stage_rows.")) > 96


@pytest.mark.parametrize("case", ["plain", "nested", "raises"])
def test_held_counts_are_added_at_the_block_end(case):
    name = f"test.trace.held.{case}"
    before = timer.counters()
    try:
        with timer.held_counts():
            timer.count(name, 2)
            if case == "nested":
                with timer.held_counts():
                    timer.count(name, 3)
                assert name not in timer.counters(since=before)
            assert name not in timer.counters(since=before)
            if case == "raises":
                raise KeyError(name)
    except KeyError:
        pass
    want = {"plain": 2, "nested": 5, "raises": None}[case]
    assert timer.counters(since=before).get(name) == want


@pytest.mark.parametrize("case", ["dominance", "none_reach"])
def test_scan_budget_rows_are_the_rows_the_scan_tier_ran(monkeypatch, index,
                                                         case):
    ran = []
    orig = single.scan_blockmin

    def scan(queries, *a, **kw):
        ran.append(queries.shape[0])
        return orig(queries, *a, **kw)

    monkeypatch.setattr(single, "scan_blockmin", scan)
    if case == "dominance":
        # uniform queries at a batch that turns the dominance gate on:
        # every row leaves the radius step for the scan tier
        q, scfg = uniform(single.SCAN_DOMINANCE_MIN_NQ), SearchConfig(knn=5)
    else:
        # corpus rows: every row finishes in the first stage
        q, scfg = index.codes[:256].clone(), SearchConfig(knn=1)
    res, c = counted(lambda: mih_search(index, q, scfg))
    assert c.get("mih.scan_budget_rows", 0) == sum(ran)
    if case == "dominance":
        assert ran == [q.shape[0]] and c["mih.scan_rows"] == q.shape[0]
        assert c["mih.dominance_trips"] == 1
        stages = single._radius_schedule(scfg, index.cfg, index.n,
                                         single._index_mask_bits(index))
        assert c.get("mih.stages_skipped", 0) == len(stages) - 1
    else:
        assert ran == [] and c["mih.scan_rows"] == 0
        assert c.get("mih.dominance_trips", 0) == 0
    assert c.get("mih.fallback_rows", 0) == 0
    assert res.dists.shape == (q.shape[0], scfg.knn)


def _ladder_scan(full, queries, flag, scan_budget, scan_fn, knn, pool_size):
    """The scan tier as a ladder of ``scan_budget * 8^i`` rows, the first
    rung that covers the flagged rows (the reference's static shapes)."""
    nq = queries.shape[0]
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
        d = torch.nn.functional.pad(d, (0, pool_size - knn),
                                    value=single.topk.INF_DIST)
        i = torch.nn.functional.pad(i, (0, pool_size - knn),
                                    value=single.topk.INVALID_ID)
        full = full._replace(
            pool_dist=single._blend(full.pool_dist, sel, flag_sel, d),
            pool_id=single._blend(full.pool_id, sel, flag_sel, i),
            done=single._blend(full.done, sel, flag_sel,
                               torch.ones_like(flag_sel)),
            overflow=single._blend(full.overflow, sel, flag_sel,
                                   torch.zeros_like(flag_sel)))
    return full


@pytest.mark.parametrize("overflow_to_scan", [False, True])
@pytest.mark.parametrize("n_sc", [0, 1, 127, 128, 129, 1024, 1025, 8192])
def test_the_scan_tier_runs_its_stragglers_rounded_to_the_query_tile(
        n_sc, overflow_to_scan):
    nq, knn, pool_size = 8192, 4, 6
    scan_budget = min(nq, max(64, nq // 64))
    gen = torch.Generator().manual_seed(n_sc)
    queries = torch.randint(-2**31, 2**31 - 1, (nq, 4), generator=gen,
                            dtype=torch.int32)
    flag = torch.zeros(nq, dtype=torch.bool)
    flag[torch.randperm(nq, generator=gen)[:n_sc]] = True
    # with overflow_to_scan, every other flagged row finished but
    # overflowed: the scan takes it as it takes an unfinished one
    ovf = flag & (torch.rand(nq, generator=gen) < 0.5) & overflow_to_scan
    state0 = single.init_state(nq, pool_size)._replace(
        pool_dist=torch.randint(0, 129, (nq, pool_size), generator=gen,
                                dtype=torch.int32),
        pool_id=torch.randint(0, 1 << 20, (nq, pool_size), generator=gen,
                              dtype=torch.int32),
        done=~flag | ovf, overflow=ovf,
        radius=torch.randint(0, 5, (nq,), generator=gen, dtype=torch.int32),
        n_cands=torch.randint(0, 1000, (nq,), generator=gen,
                              dtype=torch.int32))
    ran = []

    def scan_fn(sq):
        # a row's answer depends on that row alone, as an exact scan's does
        ran.append(sq.shape[0])
        d = (sq[:, :1] & 127) + torch.arange(knn, dtype=torch.int32)
        return d, sq[:, 1:2] ^ torch.arange(knn, dtype=torch.int32)

    got, c = counted(lambda: single.run_pipeline(
        lambda i, r, cap, q, qs, s: s, scan_fn, queries, queries, state0,
        schedule=((0, (0,)),), caps=(64,), batch_caps=(nq,), knn=knn,
        pool_size=pool_size, overflow_to_scan=overflow_to_scan))
    rows = min(nq, blockmin.QUERY_TILE * -(-n_sc // blockmin.QUERY_TILE))
    assert ran == ([rows] if n_sc else [])
    assert c.get("mih.scan_budget_rows", 0) == rows
    assert c["mih.scan_rows"] == n_sc
    want = _ladder_scan(state0, queries, flag, scan_budget, scan_fn, knn,
                        pool_size)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(got.done.all()) and not bool(got.overflow.any())


@pytest.mark.parametrize("fused", [True, False])
def test_answers_do_not_change_while_a_profiler_records(index, fused):
    scfg = SearchConfig(knn=10, fused=fused)
    q = torch.cat([neardup(index, 200), uniform(56)])
    want = mih_search(index, q, scfg)
    got, _ = profiled(lambda: mih_search(index, q, scfg))
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_show_all_timings_is_unchanged_by_counters(capsys):
    with timer.Timer("test.trace.timer"):
        pass
    first = timer.show_all_timings()
    timer.count("test.trace.counter", 7)
    assert timer.show_all_timings() == first
    assert "test.trace.counter" not in first
    assert timer.counters()["test.trace.counter"] >= 7


def test_server_stats_carry_the_counters(index):
    from verticut_tpu_torch.service import ImageSearchClient, ImageSearchServer
    srv = ImageSearchServer(index, port=0).start()
    cli = ImageSearchClient(port=srv.port, pool=1, timeout=30)
    try:
        before = cli.stats()["counters"]
        raw = codes.unpack_to_bytes(bits_lib.to_u32(index.codes[:4]))
        cli.search_batch(raw.tobytes(), 3)
        after = cli.stats()["counters"]
        assert after["mih.queries"] - before.get("mih.queries", 0) >= 4
        assert after["mih.batches"] > before.get("mih.batches", 0)
    finally:
        cli.close()
        srv.stop()


# --------------------------------------------------------------------------
# breakdown.span_split on planted events
# --------------------------------------------------------------------------

class Ev:
    """A kineto event: ``kind`` is "op", "span" (a host range of the
    program's), "launch", "kernel" or "annotation" (a ``record_function``
    range's device record)."""

    def __init__(self, name, start, dur, kind, tid=1, corr=0, linked=0,
                 stream=7):
        self._n, self._s, self._d, self._k = name, start, dur, kind
        self._t, self._c, self._l, self._st = tid, corr, linked, stream

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        dt = torch.autograd.DeviceType
        return dt.CUDA if self._k in ("kernel", "annotation") else dt.CPU

    def is_user_annotation(self):
        return self._k == "annotation"

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def device_resource_id(self):
        return self._st


US = 1_000


def planted():
    """A pipeline (thread 2, 0-100 us) holding a step (10-60) that holds a
    lookup (20-40); a kernel launched in the lookup, one launched from no
    operator inside the step (placed by its stream), one launched outside
    every span, a sync in the step, a ``record_function`` range's device
    record, and a caller's finalize on thread 1 (5-95 us)."""
    return [
        Ev("mih.pipeline", 0, 100 * US, "span", tid=2),
        Ev("mih.step.r1", 10 * US, 50 * US, "span", tid=2),
        Ev("mih.lookup", 20 * US, 20 * US, "span", tid=2),
        Ev("aten::add", 22 * US, 4 * US, "op", tid=2),
        Ev("cudaLaunchKernel", 23 * US, 2 * US, "launch", tid=2, corr=11,
           linked=5),
        Ev("kernA", 30 * US, 10 * US, "kernel", tid=2, corr=11, linked=5),
        Ev("cudaLaunchKernel", 45 * US, 1 * US, "launch", tid=1, corr=12),
        Ev("blockmin", 50 * US, 20 * US, "kernel", tid=1, corr=12),
        Ev("cudaStreamSynchronize", 50 * US, 5 * US, "launch", tid=2,
           linked=6),
        Ev("probe", 30 * US, 40 * US, "annotation", tid=1, corr=99),
        Ev("cudaLaunchKernel", 105 * US, 1 * US, "launch", tid=1, corr=13,
           stream=3),
        Ev("kernB", 110 * US, 5 * US, "kernel", tid=1, corr=13, stream=3),
        Ev("mih.finalize", 5 * US, 90 * US, "span", tid=1),
    ]


def test_split_leaves_range_device_records_out_of_busy_time():
    out = breakdown.span_split(planted(), 0, 120 * US, cuda=True)
    # kernA 30-40, blockmin 50-70, kernB 110-115: the range's device
    # record (30-70) is neither busy time nor a kernel
    assert out["busy_s"] == pytest.approx(35e-6)
    assert out["unattributed_device_s"] == pytest.approx(5e-6)


def test_split_gives_a_kernel_to_every_span_around_its_launch():
    out = breakdown.span_split(planted(), 0, 120 * US, cuda=True)
    per = out["per_batch"]
    assert set(per) == {"mih.pipeline", "mih.step.r1", "mih.lookup",
                        "mih.finalize"}
    assert per["mih.lookup"]["device_s"] == pytest.approx(10e-6)
    # the ctypes launch lies on the thread that launches its stream's
    # operator kernels, inside the step
    assert per["mih.step.r1"]["device_s"] == pytest.approx(30e-6)
    assert per["mih.pipeline"]["device_s"] == pytest.approx(30e-6)
    assert per["mih.finalize"]["device_s"] == 0
    # on the worker's thread only
    assert out["syncs_per_batch"] == 1


def test_split_self_time_subtracts_child_spans():
    per = breakdown.span_split(planted(), 0, 120 * US, cuda=True,
                               batches=2)["per_batch"]
    assert per["mih.pipeline"]["host_s"] == pytest.approx(50e-6)
    assert per["mih.pipeline"]["self_s"] == pytest.approx(25e-6)
    assert per["mih.step.r1"]["self_s"] == pytest.approx(15e-6)
    assert per["mih.lookup"]["self_s"] == pytest.approx(10e-6)
    assert per["mih.lookup"]["n"] == 0.5


def test_split_names_a_gap_by_the_span_around_it():
    gaps = dict(breakdown.span_split(planted(), 0, 120 * US,
                                     cuda=True)["idle_gaps"])
    # 0-30: its middle (15) in the step, outside any operator; 40-50: in
    # the step; 70-110: its middle (90) in the pipeline; 115-120: outside
    assert gaps["mih.step.r1"] == pytest.approx(40e-6)
    assert gaps["mih.pipeline"] == pytest.approx(40e-6)
    assert gaps[breakdown.OUTSIDE] == pytest.approx(5e-6)


def test_split_clips_spans_to_the_stretch():
    out = breakdown.span_split(planted(), 50 * US, 120 * US, cuda=True)
    per = out["per_batch"]
    assert per["mih.pipeline"]["host_s"] == pytest.approx(50e-6)
    assert per["mih.step.r1"]["host_s"] == pytest.approx(10e-6)
    # spans wholly outside the stretch are left out
    assert "mih.lookup" not in per and per["mih.step.r1"]["n"] == 1
    assert out["syncs_per_batch"] == 1


class FnEv:
    """A ``prof.events()`` entry."""

    def __init__(self, name, cuda, annotation=False):
        self.name, self.is_user_annotation = name, annotation
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = torch.autograd.profiler_util.Interval(0, 10)


def test_kernel_list_leaves_range_device_records_out():
    prof = type("P", (), {"events": lambda self: [
        FnEv("kernA", True), FnEv("probe", True, annotation=True),
        FnEv("probe", False, annotation=True),
        FnEv("cudaLaunchKernel", False)]})()
    kernels, by_name, launch_us, _ = breakdown._kernels(prof)
    assert len(kernels) == 1 and set(by_name) == {"kernA"}
    assert launch_us == 10


def test_profile_loop_on_cpu(index):
    scfg = SearchConfig(knn=10)
    qs = [neardup(index, 128, seed) for seed in range(2)]
    rec = breakdown.profile_loop(index, qs, scfg, depth=2, batches=3)
    assert len(rec["traced_batch_s"]) == len(rec["spans_off_batch_s"]) == 2
    # no fallback re-runs a row here: one pipeline a batch
    assert rec["counters"]["mih.batches"] == 3
    assert rec["counters"]["mih.queries"] == 3 * 128
    split = rec["split"]
    assert split["batches"] == 3 and split["busy_s"] is None
    assert split["syncs_per_batch"] is None and split["idle_gaps"] is None
    per = split["per_batch"]
    assert any(STEP.fullmatch(n) for n in per) and "mih.pack" in per
    assert all(x["device_s"] is None for x in per.values())
    assert per["mih.pipeline"]["n"] >= 1 and per["mih.dispatch"]["n"] >= 1
