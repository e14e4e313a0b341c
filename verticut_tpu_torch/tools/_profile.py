"""Shared helpers of the profiling tools: the corpus and queries they
measure, two timing protocols, one profiled call per measured row, the
fused pipeline with pieces switched off, and the card's bounds.

Timing, as the JAX tools time:

* :func:`rep_ms`: a warm-up call, then ``R`` calls back to back with one
  ``torch.cuda.synchronize()`` at the end, against one call the same way;
  the cost of a call is ``(t_R - t_1) / (R - 1)``, the best of ``tries``
  runs of each. A difference below the clock's noise can come out
  negative; it is reported as measured.
* :func:`best_ms`: a warm-up call, then the best of ``reps`` single calls,
  each ending in a sync;
* :func:`mean_ms`: a warm-up call, then ``reps`` calls back to back with
  one sync, per call, the best of ``tries`` runs.

The sync is ``torch.cuda.synchronize()`` for the whole device, not an event
on the caller's stream: ``mih_search_dispatch`` runs the pipeline on the
device's worker stream. :func:`profiled` runs one more call under
``torch.profiler`` and reads, with ``breakdown``'s helpers, the kernels it
launched, their device time (the union of their intervals) and the host
time spent in ``cudaLaunchKernel``.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from verticut_tpu_torch import bench, breakdown
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.search import single

#: an H100 SXM's dense int8 tensor-core rate (ops/s) and memory rate (B/s)
H100_INT8_OPS = 1979e12
H100_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def perturbed(index, q: int, seed: int = 0) -> torch.Tensor:
    """``q`` corpus rows with 3 random bit flips each, the JAX tools'
    draws from ``default_rng(seed)``."""
    return bench.perturbed_queries(np.random.default_rng(seed), index.codes, q)


def best_ms(fn, device, reps: int = 5) -> float:
    """The best of ``reps`` single calls of ``fn``, ms, after a warm-up."""
    fn()
    bench.sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        bench.sync(device)
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3


def rep_ms(fn, device, r: int = 8, tries: int = 4) -> float:
    """``(t_R - t_1) / (R - 1)`` in ms: ``R`` calls back to back and one
    call, each ended by one sync, the best of ``tries`` runs each."""
    if r < 2:
        raise ValueError(f"R = {r}: the protocol needs R >= 2")
    fn()
    bench.sync(device)

    def runner(reps):
        ts = []
        for _ in range(tries):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            bench.sync(device)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1, tr = runner(1), runner(r)
    return (tr - t1) / (r - 1) * 1e3


def mean_ms(fn, device, reps: int = 5, tries: int = 3) -> float:
    """The mean call of ``reps`` calls back to back with one sync at the
    end, the best of ``tries`` runs, ms, after a warm-up."""
    fn()
    bench.sync(device)
    ts = []
    for _ in range(tries):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        bench.sync(device)
        ts.append((time.perf_counter() - t0) / reps)
    return min(ts) * 1e3


def profiled(fn, device) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the kernels it
    launched, their device ms (the union of their intervals; None where
    the profile holds no device interval, as on the CPU), the host s of
    ``cudaLaunchKernel`` and of the calls that wait for the card, and the
    blockmin wrapper's own count of its launches in the call
    (``blockmin_launches``), which holds the profile's kernel records to
    account. The window opens with a device sync, before ``fn``."""
    from verticut_tpu_torch.kernels import blockmin as kb
    dev = torch.device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    bench.sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        bench.sync(dev)
        before = kb.launches
        fn()
        bench.sync(dev)
        bm = kb.launches - before
    kernels, _, launch_us, sync_us = breakdown._kernels(prof)
    return {"launches": len(kernels),
            "device_ms": (breakdown._union(kernels) * 1e-3 if kernels
                          else None),
            "launch_cpu_s": launch_us * 1e-6, "sync_cpu_s": sync_us * 1e-6,
            "blockmin_launches": bm}


def release(device) -> None:
    """Hand the caching allocator's free blocks back to the device, as a
    new process starts: blocks cached for one stream are not reused by
    another (the dispatch worker's), so a run that follows work on the
    caller's stream times from a clean allocator."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Rows:
    """A tool's measured rows: ``ms`` (``{name: ms}``, the JAX tools'
    JSON shape) and ``prof`` (``{name: profiled(...)}``)."""

    def __init__(self, device):
        self.device = device
        self.ms = {}
        self.prof = {}

    def add(self, name: str, ms: float, fn=None) -> float:
        self.ms[name] = ms
        if fn is not None:
            self.prof[name] = profiled(fn, self.device)
        p = self.prof.get(name)
        extra = (f"  ({p['launches']} launches, device {p['device_ms']} ms,"
                 f" launch host {p['launch_cpu_s'] * 1e3:.2f} ms)"
                 if p else "")
        log(f"  {name:46s} {ms:9.3f} ms{extra}")
        return ms


# --------------------------------------------------------------------------
# The fused pipeline with pieces switched off
# --------------------------------------------------------------------------

def fused_variant(index, queries, scfg: SearchConfig, *, scan: bool = True,
                  retry: bool = True, n_stages=None, dominance: bool = True,
                  overflow_to_scan: bool = False) -> torch.Tensor:
    """The fused pipeline's packed result row (``single._fused_row``) for
    one batch, on the caller's thread and stream, with pieces switched
    off as the JAX profiling tools switch them: ``scan`` the scan ladder,
    ``retry`` the overflow retry ladder, ``n_stages`` keeps the first
    stages of the fused schedule, ``dominance`` the dominance gate (its
    threshold ``nq // 2`` whenever the scan ladder runs, at any batch
    size), ``overflow_to_scan`` the merged ladder (``SearchConfig.
    overflow_to_scan``). The caps, the schedule and the
    :func:`~verticut_tpu_torch.search.single.tier_plan` are the fused
    driver's own; the variant edits the plan, then runs the pipeline."""
    scfg = dataclasses.replace(scfg, overflow_to_scan=overflow_to_scan)
    scfg, queries, schedule = single._prepare(index, queries, scfg)
    schedule = single.fused_stages(scfg, schedule,
                                   single._index_mask_bits(index))
    if n_stages is not None:
        schedule = schedule[:n_stages]
    if not schedule:
        raise ValueError("no radius stage fits fused_max_masks")
    nq = queries.shape[0]
    args = single._fused_args(index, queries, scfg, None, schedule)
    if not scan:
        args.update(single.tier_plan(scfg, index.n, nq, schedule,
                                     args["caps"], scan=False), scan_fn=None)
    if not retry:
        args.update(retry_caps=None, retry_budget=0)
    args["scan_dominance"] = nq // 2 if dominance else 0
    full = single.run_pipeline(**args)
    return single._pack_row(full, scfg.knn, single._result_id_bits(
        index.tables, index.cfg.bits))


def row_fields(index, row: torch.Tensor, k: int) -> dict:
    """A packed row decoded on the host (``single._unpack_row``)."""
    return single._unpack_row(row.cpu(), k, single._result_id_bits(
        index.tables, index.cfg.bits))


def tier_counts(index, row: torch.Tensor, k: int):
    """``(done, overflow)``: the rows of a packed result whose flags word
    has bit 0 (done) and bit 1 (overflow) set."""
    f = row_fields(index, row, k)
    return int((~f["not_done"]).sum()), int(f["overflow"].sum())


def finalized_equal(index, queries, scfg: SearchConfig, row: torch.Tensor,
                    want) -> bool:
    """A variant's packed row, finished by the host fallbacks as
    ``mih_search_finalize`` finishes the fused driver's (retry at 4x caps,
    the exact scan of unfinished rows), equals ``want`` (``mih_search``'s
    result) in dists and ids: the variant kept the answer exact."""
    scfg, queries, _ = single._prepare(index, queries, scfg)
    got = single._fallbacks(index, queries, scfg, None,
                            row_fields(index, row, scfg.knn))
    return bool(torch.equal(got.dists, want.dists)
                and torch.equal(got.ids, want.ids))


# --------------------------------------------------------------------------
# Bounds
# --------------------------------------------------------------------------

def blockmin_bound(nq: int, n: int, w: int, block: int):
    """The least time, ms, of a blockmin pass over ``n`` rows: its
    ``2 * Q * n * 32W`` int8 tensor-core operations, or its bytes (the
    queries and rows read once, the ``[Q, n / block]`` minima written
    once), whichever takes longer; and which it is."""
    ops = 2 * nq * n * 32 * w / H100_INT8_OPS * 1e3
    by_bytes = 4 * (nq * w + n * w + nq * -(-n // block)) / H100_BYTES * 1e3
    return (ops, "operations") if ops >= by_bytes else (by_bytes, "bytes")


def fail_on(checks: dict, tool: str) -> int:
    """0 if every check holds, else 1 with the failing ones logged: a
    timing of a wrong answer is no timing."""
    bad = [k for k, v in checks.items() if not v]
    if bad:
        log(f"{tool}: checks failed: {bad}")
        return 1
    return 0
