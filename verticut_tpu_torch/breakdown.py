"""Where a batch's time goes: one warm batch of a benchmark cell under
``torch.profiler``.

Run on a machine with an NVIDIA GPU:

    python -m verticut_tpu_torch.breakdown [N ...]

For each corpus size N (by default 1,000,000 and 100,000,000) it builds the
benchmark's index (:func:`verticut_tpu_torch.bench.make_index`) and
profiles one warm 8192-query batch of the uniform cell
(``random_codes(99, 8192)``) and of the k = 10 cell (corpus rows with 3
bit flips), both at k = 10. It prints one JSON line per cell:

* ``wall_s``: the median of three unprofiled warm batches (``mih_search``
  ending in a device sync);
* ``device_s``: the union of the card's kernel intervals in the profiled
  batch, and ``idle`` = 1 - device_s / wall_s;
* ``kernels``: kernels launched, ``launch_cpu_s``, the host time of
  ``cudaLaunchKernel``, and ``sync_cpu_s``, the host time of the calls
  that wait for the card (:data:`SYNC_CALLS`);
* ``top``: the kernels by device time (name up to its argument list,
  seconds, launches), ``blockmin``, the batch's blockmin launches by
  instance, and ``fetch_score``, its fetch + score kernel launches (one a
  table and radius step on the card, none on the CPU).

For the k = 10 cell it prints one more line, ``pair``
(:func:`profile_pair`): two batches back to back against two handles in
flight through ``mih_search_dispatch`` / ``mih_search_finalize``, three
timed runs of each and one profiled, with ``concurrent_s``, the time the
card ran kernels of two streams at once.

With ``--spans`` (``python -m verticut_tpu_torch.breakdown --spans [N
...]``, by default N = 100,000,000) it prints instead one JSON line per
cell of :func:`profile_loop`: a stretch of the depth-4
dispatch/finalize loop split by the program's spans (host, self and
device time per span and batch, syncs, the device's idle gaps by
span), the program's counters over a stretch, and the cost of the
spans when a profiler records. The k = 10, k = 100 and uniform cells.
:func:`span_split` is a stopgap beside the benchmark's own reducer
(``benchmark/trace.py``): it goes when that reducer reads the spans, and
does not grow meanwhile.

It exits non-zero without CUDA. :func:`profile_cell` takes any device; on
the CPU the profile has no device intervals and ``device_s`` is None.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import sys
import time
import types

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import bench, codes
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.kernels import fetch_score as kf
from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                       mih_search_finalize)
from verticut_tpu_torch.utils import timer

Q = 8192
TOP = 10


def _short(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:100]


def _merge(intervals) -> list:
    """The union of ``(start, end)`` intervals as disjoint ones, in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(b, out[-1][1]))
        else:
            out.append((a, b))
    return out


def _union(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in _merge(intervals))


#: the calls that make the host wait for the card: the stage gates'
#: scalar reads, the row's event, the final sync
WAIT_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")
#: the host time of a wait also holds the copy behind a scalar read
SYNC_CALLS = WAIT_CALLS + ("cudaMemcpyAsync",)


def _kernels(prof):
    """The profile's kernel intervals (us), ``{name: (us, launches)}``, the
    host us of ``cudaLaunchKernel`` and of the :data:`SYNC_CALLS`. A
    ``record_function`` range's record on the device (the range of the
    kernels launched inside it) is no kernel and is left out."""
    kernels, by_name, launch_us, sync_us = [], {}, 0.0, 0.0
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.end))
            t, c = by_name.get(_short(e.name), (0.0, 0))
            by_name[_short(e.name)] = (t + e.time_range.elapsed_us(), c + 1)
        elif e.name == "cudaLaunchKernel":
            launch_us += e.time_range.elapsed_us()
        elif e.name in SYNC_CALLS:
            sync_us += e.time_range.elapsed_us()
    return kernels, by_name, launch_us, sync_us


# --------------------------------------------------------------------------
# The split by span of a stretch of the dispatch/finalize loop
# --------------------------------------------------------------------------

PIPELINE = "mih.pipeline"
#: the program's span names begin with these
SPAN_PREFIXES = ("mih.", "scan.")
OUTSIDE = "outside_spans_and_operators"


def _is_launch(name: str) -> bool:
    return name.startswith(("cudaLaunch", "cuLaunch"))


def _enclosing(intervals, points):
    """For each ``(point, key)`` in ``points``: ``key`` and the list of the
    ``intervals`` (``(start, end, item)``, properly nested) that hold the
    point, outermost first."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    stack, j = [], 0
    for x, key in sorted(points, key=lambda p: p[0]):
        while j < len(intervals) and intervals[j][0] <= x:
            while stack and stack[-1][1] < intervals[j][0]:
                stack.pop()
            stack.append(intervals[j])
            j += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        yield key, [iv[2] for iv in stack]


def span_split(events, t0: int, t1: int, cuda: bool,
               batches: int = 1) -> dict:
    """The stretch ``[t0, t1]`` (ns, the profiler's clock) of a profile
    (``kineto_results.events()``) split by the program's spans
    (:func:`verticut_tpu_torch.utils.timer.span`: host ranges named by
    :data:`SPAN_PREFIXES`), over the ``batches`` it finalized.
    ``per_batch``: for each span name its instances ``n``
    inside the stretch, host seconds clipped to it, self seconds (less the
    part its child spans cover) and the device seconds of the kernels
    launched inside it, counted to every enclosing span. A kernel's launch
    record (``cudaLaunch*`` / ``cuLaunch*``, matched by correlation id)
    lies on the thread of the operator it was launched from; a launch
    from outside any operator (a ctypes kernel) carries no thread of its
    own and is placed on the thread that launches the operators' kernels
    on its stream. Kernels with no launch record inside a span are
    ``unattributed_device_s``. On the thread of the ``mih.pipeline``
    spans (the dispatch worker): ``syncs_per_batch``, its
    :data:`WAIT_CALLS`, and ``idle_gaps``, the stretch's device gaps by
    the innermost span or operator running at their middle. Device
    numbers are None without ``cuda``."""
    dev_t = torch.autograd.DeviceType.CUDA
    device, kernels, host, launches = [], [], {}, {}
    spans = []                                # (start, end, name, tid)
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == dev_t:
            if e.is_user_annotation():          # a record_function range
                continue
            a, b = max(start, t0), min(end, t1)
            if a >= b:
                continue
            device.append((a, b))
            if not e.name().startswith(("Memcpy", "Memset")):
                kernels.append((a, b, e.correlation_id(),
                                e.device_resource_id()))
            continue
        tid = e.start_thread_id()
        host.setdefault(tid, []).append((start, end, e.name()))
        if e.name().startswith(SPAN_PREFIXES):
            spans.append((start, end, e.name(), tid))
        elif _is_launch(e.name()):
            launches[e.correlation_id()] = (start, tid,
                                            e.linked_correlation_id() != 0)
    # the thread that launches each stream's operator kernels
    votes = {}
    for a, b, corr, stream in kernels:
        r = launches.get(corr)
        if r is not None and r[2]:
            votes.setdefault(stream, collections.Counter())[r[1]] += 1
    owner = {st: v.most_common(1)[0][0] for st, v in votes.items()}

    # per span instance: host ns in the stretch, its children's, device ns
    inst = [{"name": n, "host": max(0, min(e, t1) - max(s, t0)),
             "child": 0, "device": 0} for s, e, n, _ in spans]
    by_tid = {}
    for i, (s, e, _, t) in enumerate(spans):
        by_tid.setdefault(t, []).append((s, e, i))
    for ivs in by_tid.values():
        for i, chain in _enclosing(ivs, [(s, i) for s, _, i in ivs]):
            chain = chain[:chain.index(i)]          # i's ancestors
            if chain:
                inst[chain[-1]]["child"] += inst[i]["host"]
    unattributed = 0
    points = {}
    for a, b, corr, stream in kernels:
        r = launches.get(corr)
        if r is None:
            unattributed += b - a
            continue
        tid = r[1] if r[2] else owner.get(stream, r[1])
        points.setdefault(tid, []).append((r[0], b - a))
    for tid, pts in points.items():
        for dur, chain in _enclosing(by_tid.get(tid, []), pts):
            if not chain:
                unattributed += dur
            for i in chain:
                inst[i]["device"] += dur

    per_batch = {}
    for x in inst:
        if x["host"] > 0:
            o = per_batch.setdefault(x["name"], {
                "n": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0})
            o["n"] += 1
            o["host_s"] += x["host"] * 1e-9
            o["self_s"] += (x["host"] - x["child"]) * 1e-9
            o["device_s"] += x["device"] * 1e-9
    for o in per_batch.values():
        for k in o:
            o[k] /= batches
        if not cuda:
            o["device_s"] = None
    workers = collections.Counter(t for _, _, n, t in spans if n == PIPELINE)
    worker = workers.most_common(1)[0][0] if workers else None
    syncs = sum(1 for s, _, n in host.get(worker, [])
                if n in WAIT_CALLS and t0 <= s <= t1)
    busy = _merge(device)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    owners = collections.Counter()
    for (a, b), chain in _enclosing(
            [(s, e, n) for s, e, n in host.get(worker, []) if e > s],
            [((a + b) // 2, (a, b)) for a, b in gaps]):
        owners[chain[-1] if chain else OUTSIDE] += (b - a) * 1e-9
    return {
        "window_s": (t1 - t0) * 1e-9, "batches": batches,
        "busy_s": sum(b - a for a, b in busy) * 1e-9 if cuda else None,
        "unattributed_device_s": unattributed * 1e-9 if cuda else None,
        "syncs_per_batch": syncs / batches if cuda else None,
        "per_batch": dict(sorted(per_batch.items(),
                                 key=lambda kv: -kv[1]["self_s"])),
        "idle_gaps": owners.most_common(TOP) if cuda else None}


def _all_threads() -> dict:
    """Profiler arguments that record the operators and spans of every
    thread, the dispatch worker's too: by default a profiler records the
    thread that started it."""
    return {"experimental_config": torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)}


@contextlib.contextmanager
def _spans_off():
    """Spans read the profiler as not recording: every span is the
    no-op, while the profiler records operators and kernels."""
    saved = timer._profiler
    timer._profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    try:
        yield
    finally:
        timer._profiler = saved


def profile_loop(index, batches_q, scfg: SearchConfig, depth: int = 4,
                 batches: int = 8) -> dict:
    """A closed loop that keeps ``depth`` batches in flight through
    ``mih_search_dispatch`` / ``mih_search_finalize``, cycling through
    the query batches ``batches_q``: after a warm-up, one stretch of
    ``batches`` finalized batches unprofiled (``untraced_batch_s``, and
    ``counters``, what each of the program's counters added in it; a
    batch whose fallbacks re-run rows adds a pipeline of its own), then,
    after one more that warms the profiler up, four under the profiler
    recording every thread, in turns with spans and with spans off
    (``traced_batch_s``, ``spans_off_batch_s``: seconds a batch of each
    stretch; the difference is the cost of the spans). Each stretch
    fills the loop and turns it ``depth`` times before it starts, and
    drains the loop after it ends; a profiler starts and stops while the
    dispatch worker is idle. ``split`` is :func:`span_split` of the last
    profiled stretch."""
    dev = index.device
    cuda = dev.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    inflight, nxt = collections.deque(), [0]

    def dispatch():
        q = batches_q[nxt[0] % len(batches_q)]
        nxt[0] += 1
        inflight.append(mih_search_dispatch(index, q, scfg))

    def turns(n):
        for _ in range(n):
            mih_search_finalize(inflight.popleft())
            dispatch()

    def stretch(n=batches):
        for _ in range(depth):
            dispatch()
        turns(depth)
        before = timer.counters()
        t0 = time.time_ns()
        turns(n)
        t1 = time.time_ns()
        counted = timer.counters(since=before)
        while inflight:
            mih_search_finalize(inflight.popleft())
        return t0, t1, counted

    stretch(depth)                                   # warm-up
    t0, t1, counted = stretch()
    out = {"depth": depth, "batches": batches,
           "untraced_batch_s": (t1 - t0) * 1e-9 / batches,
           "counters": dict(sorted(counted.items())),
           "traced_batch_s": [], "spans_off_batch_s": [], "split": None}
    for i, spans in enumerate((True, True, False, False, True)):
        with contextlib.ExitStack() as stack:
            if not spans:
                stack.enter_context(_spans_off())
            with torch.profiler.profile(activities=acts,
                                        **_all_threads()) as prof:
                t0, t1, _ = stretch()
        bench.log(f"breakdown: profiled stretch, spans {spans}: "
                  f"{(t1 - t0) * 1e-9 / batches:.4f} s a batch")
        if i == 0:
            continue
        key = "traced_batch_s" if spans else "spans_off_batch_s"
        out[key].append((t1 - t0) * 1e-9 / batches)
        if i == 4:
            out["split"] = span_split(prof.profiler.kineto_results.events(),
                                      t0, t1, cuda, batches)
    return out


def profile_pair(index, queries, scfg: SearchConfig, reps: int = 3,
                 check=None, profile: bool = True) -> dict:
    """Two batches back to back (``mih_search`` twice) against two handles
    in flight (two dispatches, then two finalizes): a warm-up of each, then
    ``reps`` timed runs of each in turns. Per mode ``batch_s``, the median
    wall seconds per batch, and ``runs_s``; in flight also ``dispatch_s``,
    the median time the first dispatch took to return. ``check(mode,
    result)`` sees every result. With ``profile``, one more run of each
    mode under the profiler adds ``device_s`` (the union of kernel
    intervals), ``kernel_s`` (their sum), ``concurrent_s`` = kernel_s -
    device_s, the time the card ran two kernels at once (one stream runs
    its kernels one at a time, so only the worker's and the caller's
    streams overlap), ``idle`` and ``kernels``."""
    dev = index.device
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    dispatch = []

    def back_to_back():
        return [mih_search(index, queries, scfg) for _ in range(2)]

    def in_flight():
        t0 = time.perf_counter()
        h = [mih_search_dispatch(index, queries, scfg)]
        dispatch.append(time.perf_counter() - t0)
        h.append(mih_search_dispatch(index, queries, scfg))
        return [mih_search_finalize(x) for x in h]

    def timed(mode, fn):
        t0 = time.perf_counter()
        results = fn()
        bench.sync(dev)
        wall = time.perf_counter() - t0
        if check is not None:
            for res in results:
                check(mode, res)
        return wall / 2

    modes = (("back_to_back", back_to_back), ("in_flight", in_flight))
    runs = {name: [] for name, _ in modes}
    for name, fn in modes:
        timed(name, fn)                              # warm-up
    dispatch.clear()
    for rep in range(reps):
        for name, fn in modes if rep % 2 == 0 else modes[::-1]:
            runs[name].append(timed(name, fn))
    out = {name: {"batch_s": statistics.median(r), "runs_s": r}
           for name, r in runs.items()}
    out["in_flight"]["dispatch_s"] = statistics.median(dispatch)
    if not profile:
        return out
    for name, fn in modes:
        with torch.profiler.profile(activities=acts) as prof:
            wall = timed(name, fn)
        kernels, _, _, _ = _kernels(prof)
        device = _union(kernels) * 1e-6 if kernels else None
        total = sum(e - s for s, e in kernels) * 1e-6
        out[name].update(
            profiled_batch_s=wall, device_s=device,
            kernel_s=total if kernels else None,
            concurrent_s=None if device is None else total - device,
            idle=None if device is None else 1 - device / (2 * wall),
            kernels=len(kernels))
    return out


def profile_cell(index, queries, scfg: SearchConfig) -> dict:
    """One warm batch of ``mih_search(index, queries, scfg)`` under the
    profiler, beside three unprofiled ones (see the module docstring)."""
    dev = index.device
    mih_search(index, queries, scfg)                 # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        mih_search(index, queries, scfg)
        bench.sync(dev)
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = dict(kb.launches_by_instance)
    fetch_before = kf.launches
    with torch.profiler.profile(activities=acts) as prof:
        mih_search(index, queries, scfg)
        bench.sync(dev)
    blockmin = {k: v - before[k] for k, v in kb.launches_by_instance.items()}
    fetch_score = kf.launches - fetch_before
    kernels, by_name, launch_us, sync_us = _kernels(prof)
    wall = statistics.median(walls)
    device = _union(kernels) * 1e-6 if kernels else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"wall_s": wall, "walls_s": walls, "device_s": device,
            "idle": None if device is None else 1 - device / wall,
            "kernels": len(kernels), "launch_cpu_s": launch_us * 1e-6,
            "sync_cpu_s": sync_us * 1e-6,
            "top": [[n, t * 1e-6, c] for n, (t, c) in top],
            "blockmin": blockmin, "fetch_score": fetch_score}


def run(n: int, device) -> list:
    """The uniform and k = 10 cells at corpus size ``n`` on ``device``."""
    index, info = bench.make_index(n, device)
    scfg = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    cells = (("uniform k=10", bits_lib.as_codes(
                 codes.random_codes(99, Q, bench.CFG.bits), device)),
             ("k=10", bench.perturbed_queries(np.random.default_rng(0),
                                              index.codes, Q)))
    out = []
    for name, q in cells:
        rec = {"n": n, "cell": name, **profile_cell(index, q, scfg)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    rec = {"n": n, "cell": "k=10 pair", **profile_pair(index, q, scfg)}
    print(json.dumps(rec), flush=True)
    out.append(rec)
    del index
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_spans(n: int, device, depth: int = 4, batches: int = 8) -> list:
    """:func:`profile_loop` at corpus size ``n`` on ``device``: batches of
    ``Q`` near-duplicate queries at k = 10 and k = 100, and uniform
    queries at k = 10, each cycling through 4 batches."""
    index, _ = bench.make_index(n, device)
    rng = np.random.default_rng(0)
    neardup = [bench.perturbed_queries(rng, index.codes, Q)
               for _ in range(4)]
    uniform = [bits_lib.as_codes(codes.random_codes(99 + i, Q,
                                                    bench.CFG.bits), device)
               for i in range(4)]
    out = []
    for name, qs, k in (("k=10", neardup, 10), ("k=100", neardup, 100),
                        ("uniform k=10", uniform, 10)):
        scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
        rec = {"n": n, "cell": name, "q": Q,
               **profile_loop(index, qs, scfg, depth, batches)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    del index
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        bench.log("breakdown: torch.cuda.is_available() is False; the profile "
                  "measures a CUDA card")
        return 2
    bench.log(json.dumps(bench.card()))
    spans = "--spans" in argv
    sizes = [int(a) for a in argv if a != "--spans"]
    for n in sizes or ([100_000_000] if spans
                       else [1_000_000, 100_000_000]):
        (run_spans if spans else run)(n, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
