"""Run one cell across several cards: one process per card, in lockstep,
through the port's sharded engines.

A configuration selects this path by naming a mesh in its file,
``"mesh": {"table": T, "shard": S, "query": Q}``, with ``T * S * Q`` equal
to the cell's ``chips``; its ``layout`` chooses the engine:
``build_sharded_index`` / ``sharded_mih_search`` (inline rows) or
``build_sharded_compact`` / ``sharded_compact_search`` (compact). The
parent process starts the world with ``verticut_tpu_torch.parallel.world.
spawn`` (rank r on card r) and prints the one result line; it holds no
card itself.

Every rank makes the corpus from the seed on its own card and builds its
slices with the program's sharded build; ranks other than 0 then drop the
corpus. The sharded engines have no dispatch/finalize pair, so the loop
keeps one batch in flight: each turn rank 0 makes batch ``i`` from the
seed as the single-card loop does, broadcasts it with a flag that says
whether the stage goes on, and every rank searches it. Rank 0 alone
decides when the warm-up, the window and the traced stretch end, so every
rank makes the same calls. With ``--trace 1`` every rank profiles its own
card over the same turns.

Every rank returns the whole result of each batch and keeps a digest of
it; after the window rank 0 counts the batches whose digests differ
across ranks (``rank_mismatches``, limit 0), then frees its index and
holds its sample against the reference, as on one card.

Collectives wait at most :data:`WORLD_TIMEOUT`. A rank that raises, or
dies, ends the world; the parent then prints a result line that is not
correct and counts as failed every query dispatched and not answered.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import hashlib
import os
import statistics
import sys
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from benchmark import gen
from benchmark import run as run_lib
from benchmark import spec as spec_lib
from benchmark import trace as trace_lib
from benchmark.check import Keeper, check

#: how long a collective waits for its peers before the world fails
WORLD_TIMEOUT = datetime.timedelta(seconds=120)
#: the flag of a turn's broadcast
STOP, GO = 0, 1
#: a traced stretch keeps one batch in flight, so one turn settles it
TRACE_SETTLE = 1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def mesh_shape(cell: spec_lib.Cell) -> tuple:
    """``(table, shard, query)`` of the configuration's mesh."""
    m = cell.config["mesh"]
    return int(m["table"]), int(m["shard"]), int(m["query"])


def refusal(cell: spec_lib.Cell) -> Optional[str]:
    """Why the multi-card path cannot run ``cell``, or None."""
    t, s, q = mesh_shape(cell)
    if t * s * q != cell.chips:
        return (f"{cell.name}: mesh {t}x{s}x{q} spans {t * s * q} cards, "
                f"the cell asks for {cell.chips}")
    depth = int(cell.traffic["depth"])
    if depth != 1:
        return (f"{cell.name}: traffic depth {depth}; the sharded engines "
                "have no dispatch/finalize pair, so a multi-card cell keeps "
                "one batch in flight (depth 1)")
    return None


def digest(res) -> str:
    """A digest of one batch's answers, ``(dists, ids)``."""
    h = hashlib.blake2b(digest_size=16)
    h.update(res.dists.numpy().tobytes())
    h.update(res.ids.numpy().tobytes())
    return h.hexdigest()


def mismatches(digests: list) -> int:
    """Batches whose digests are not the same on every rank (a batch some
    rank lacks counts too)."""
    n = max(len(d) for d in digests)
    return sum(len({d[i] if i < len(d) else None for d in digests}) > 1
               for i in range(n))


class Lockstep:
    """One batch at a time over the world. Rank 0 :meth:`turn`\\ s and
    :meth:`stop`\\ s; the other ranks :meth:`follow`. ``make(i)`` makes
    batch ``i`` of ``q`` queries on rank 0's device. The batch and the
    flag travel in one broadcast: the queries in the buffer's first ``q``
    rows (so they keep the buffer's alignment), the flag in its last."""

    def __init__(self, search: Callable, index, scfg, make: Callable,
                 q: int, w: int, device, progress: torch.Tensor = None):
        self.search, self.index, self.scfg = search, index, scfg
        self.make, self.q = make, q
        self.buf = torch.zeros((q + 1, w), dtype=torch.int32, device=device)
        self.progress = progress    # queries dispatched and answered
        self.next_i = 0
        self.digests = []

    def _answer(self):
        res = self.search(self.index, self.buf[:self.q], self.scfg)
        self.digests.append(digest(res))
        return res

    def turn(self):
        """``(i, called, returned, n_queries, result)`` of the next batch,
        as :meth:`benchmark.run.Loop.turn` gives them."""
        i = self.next_i
        self.next_i += 1
        self.buf[:self.q] = self.make(i)
        self.buf[self.q, 0] = GO
        if self.progress is not None:
            self.progress[0] += self.q
        t = time.perf_counter()
        dist.broadcast(self.buf, 0)
        res = self._answer()
        t1 = time.perf_counter()
        if self.progress is not None:
            self.progress[1] += self.q
        return i, t, t1, self.q, res

    def fill(self) -> None:
        """One batch in flight: nothing to fill (``measure`` calls it)."""

    def stop(self) -> None:
        self.buf[self.q, 0] = STOP
        dist.broadcast(self.buf, 0)

    def follow_one(self) -> bool:
        """Answer rank 0's next batch; False at its stop."""
        dist.broadcast(self.buf, 0)
        if int(self.buf[self.q, 0]) == STOP:
            return False
        self._answer()
        return True

    def follow(self) -> None:
        while self.follow_one():
            pass


def _engine(layout: str):
    """``(build, search)`` of the sharded engine for ``layout``, looked up
    when called."""
    from verticut_tpu_torch.search import sharded, sharded_compact
    if layout == "inline":
        return sharded.build_sharded_index, sharded.sharded_mih_search
    if layout == "compact":
        return (sharded_compact.build_sharded_compact,
                sharded_compact.sharded_compact_search)
    raise ValueError(f"unknown layout {layout!r}")


def _forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(run_lib.FORBIDDEN))


def rank_main(rank: int, *args) -> dict:
    """The body of rank ``rank`` (:func:`_rank_body`). A rank that raises
    prints its traceback and leaves at once: leaving the world in order
    would wait, in NCCL's teardown, for peers that wait on its next
    collective, until their timeout. Its exit ends the world."""
    try:
        return _rank_body(rank, *args)
    except BaseException:
        log(f"bench[{rank}]: {traceback.format_exc()}")
        os._exit(1)


def _rank_body(rank: int, cell: spec_lib.Cell, seed: int, seconds: float,
               trace: bool, control: Optional[str], t_start: float,
               progress: torch.Tensor, fault: Optional[Callable]) -> dict:
    """Rank 0 returns ``{"line", "forbidden"}``, the others
    ``{"forbidden"}``. ``fault(rank)``, where given, runs first: the tests
    plant faults in the ranks with it."""
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.parallel import make_mesh, world

    if fault is not None:
        fault(rank)
    lead = rank == 0
    mesh = make_mesh(*mesh_shape(cell))
    # every group this rank's collectives run over
    for group in (None, mesh.model_group, mesh.query_group):
        dist.distributed_c10d._set_pg_timeout(WORLD_TIMEOUT, group)
    device = world.world_device()
    cuda = device.type == "cuda"
    cfg = cell.config
    build, search = _engine(cfg["layout"])

    t_gen = time.perf_counter()
    corpus = gen.corpus(cfg, seed, device)
    run_lib.sync(device)
    t0 = time.perf_counter()
    try:
        index = build(corpus, MIHConfig(bits=int(cfg["bits"]),
                                        n_tables=int(cfg["n_tables"])), mesh)
        run_lib.sync(device)
    finally:
        if cuda:
            log(f"bench[{rank}]: build peak "
                f"{torch.cuda.max_memory_allocated(device)} B")
    build_s = time.perf_counter() - t0
    dist.barrier()
    if not lead:
        corpus = None
    scfg = run_lib.search_config(cell)
    q, w = cell.batch, int(cfg["bits"]) // 32

    def loop(stream: int, counted: Optional[torch.Tensor] = None):
        return Lockstep(search, index, scfg, lambda i: gen.batch(
            cell.traffic, seed, i, corpus, q, stream=stream), q, w, device,
            counted)

    warm = loop(gen.WARMUP)
    if lead:
        for _ in range(run_lib.WARMUP_BATCHES):
            warm.turn()
        warm.stop()
    else:
        warm.follow()
    run_lib.sync(device)

    timed = loop(gen.QUERIES, progress if lead else None)
    run = run_lib.Run(cell=cell, device=device, seed=seed,
                      n_codes=int(cfg["n_codes"]), corpus=corpus)
    if lead:
        keeper = Keeper(seed, scfg.knn, int(cfg["n_tables"]))
        t_win = time.perf_counter()
        run.setup_s = t_win - t_start
        run.window = run_lib.measure(timed, seconds, keeper)
        timed.stop()
        log(f"bench: {cell.name} seed {seed} on {dist.get_world_size()} "
            f"ranks: set-up {run.setup_s:.2f} s (start, ranks and imports "
            f"{t_gen - t_start:.2f}, corpus {t0 - t_gen:.2f}, rank 0's build "
            f"{build_s:.2f}, warm-up {t_win - t0 - build_s:.2f}), "
            f"{run.window.batches} batches, {run.window.queries} queries in "
            f"{run.window.span_s:.3f} s")
    else:
        timed.follow()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if lead and cuda:
        log("bench: card at the close: "
            + run_lib.card("clocks.sm,temperature.gpu,power.draw"))

    tr = None
    if trace:
        step = ((lambda: timed.turn()[4] is not None) if lead
                else timed.follow_one)
        tr = trace_lib.traced(step, run_lib.TRACE_BATCHES, cuda,
                              settle=TRACE_SETTLE)
        timed.stop() if lead else timed.follow()

    mine = {"peak": peak, "build_s": build_s, "digests": timed.digests,
            "busy_s": tr.busy_s if tr else None}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    log(f"bench[{rank}]: peak {peak} B, build {build_s:.3f} s")
    if not lead:
        del index, warm, timed
        return {"forbidden": _forbidden()}

    run.peak_bytes = sum(e["peak"] for e in every)
    run.build_s = max(e["build_s"] for e in every)
    if tr is not None:
        run.trace = dataclasses.replace(
            tr, busy_s=statistics.fmean(e["busy_s"] for e in every))
    metrics = spec_lib.read_metrics(
        cell.per_layer if trace else cell.end_to_end, run)
    sample = keeper.sample()
    # a batch that fails ends the world: a finished world failed none
    attempted, failed = int(progress[0]), 0
    differ = mismatches([e["digests"] for e in every])

    del index, warm, timed, corpus
    run.corpus = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    compared = check(cell, seed, device, sample, failed, control)
    compared["rank_mismatches"] = (differ, 0)

    out = {"correct": all(v <= lim for v, lim in compared.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(device) if cuda
                               else "cpu"),
                      "count": dist.get_world_size(),
                      "memory_peak_bytes": max(e["peak"] for e in every)}}
    if trace:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    if cuda:
        out["card"] = run_lib.card()
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, (v, lim) in compared.items()}
    return {"line": out, "forbidden": _forbidden()}


def run_cell(cell: spec_lib.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             control: Optional[str] = None,
             fault: Optional[Callable] = None) -> Optional[dict]:
    """One run of ``cell`` over a world of ``cell.chips`` ranks on
    ``device`` (``"cuda"``, NCCL; ``"cpu"``, gloo), its set-up counted
    from ``t_start`` (a ``time.perf_counter()`` reading: the host's
    monotonic clock, which the ranks' processes share):
    the result line as a dict, or None where a process of the run holds a
    forbidden module."""
    from torch.multiprocessing.spawn import ProcessException
    from verticut_tpu_torch.parallel import world

    why = refusal(cell)
    if why:
        raise ValueError(why)
    # rank 0's queries dispatched and answered: read when the world fails
    progress = torch.zeros(2, dtype=torch.int64).share_memory_()
    try:
        outs = world.spawn(rank_main, cell.chips, cell, seed, seconds, trace,
                           control, t_start, progress, fault, device=device,
                           threads=run_lib.THREADS)
    except ProcessException as e:
        log(f"bench: the world of {cell.name} failed:\n{e}")
        attempted, answered = progress.tolist()
        compared = {"failed_queries": attempted - answered,
                    "unchecked_window": 1}
        out = {"correct": False, "attempted": attempted,
               "failed": attempted - answered, "metrics": {},
               "device": {"platform": "gpu" if device == "cuda" else "cpu",
                          "kind": (run_lib.card("name") if device == "cuda"
                                   else "cpu"),
                          "count": cell.chips, "memory_peak_bytes": 0},
               "compared": {k: {"value": v, "limit": 0}
                            for k, v in compared.items()}}
        return out
    found = sorted({m for o in outs for m in o["forbidden"]}
                   | set(_forbidden()))
    if found:
        log(f"bench: the run's processes hold {found} after the window")
        return None
    return outs[0]["line"]

