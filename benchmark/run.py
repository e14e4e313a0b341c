"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Set-up makes the corpus on the card from the seed, builds the
index (``verticut_tpu_torch.index.build_index``) and warms up the cell's
own shapes. The window is one client's closed loop that keeps ``depth``
batches of fresh queries in flight through ``mih_search_dispatch`` /
``mih_search_finalize`` for ``--seconds`` seconds. With ``--trace 1`` the
loop runs on, under ``torch.profiler``, for a traced stretch, and the
per-layer metrics are printed instead of the end-to-end ones. Once the
window has closed and the program's state is freed, a sample of the
window's answers, drawn from the seed, is held against the brute-force
reference (``check.py``). ``--control tail`` holds, in the program's
place, the reference over all but the last 1/64 of the corpus: the
control, which has to come out not correct.

A configuration that names a mesh runs across several cards instead, one
process per card through the program's sharded engines
(``multicard.py``).

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each compared number beside its
limit; the same numbers are the last lines on standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

from benchmark import spec as spec_lib  # noqa: E402

import torch  # noqa: E402

from benchmark import gen  # noqa: E402
from benchmark.check import Keeper, check  # noqa: E402
from benchmark import trace as trace_lib  # noqa: E402

#: modules whose presence after the window fails the run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "verticut_tpu")
#: host threads of the process's intra-op pool
THREADS = 2
#: warm-up batches, at the loop's depth
WARMUP_BATCHES = 6
#: the controls, which have to come out not correct
CONTROLS = ("tail",)
#: batches finalized in the traced stretch, after the loop's depth of
#: turns that settle it
TRACE_BATCHES = 8


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# The closed loop
# --------------------------------------------------------------------------

class Loop:
    """One client keeping up to ``depth`` batches in flight. ``make(i)``
    makes batch ``i``'s queries on the device."""

    def __init__(self, index, scfg, make: Callable, depth: int):
        from verticut_tpu_torch import search
        self.search = search
        self.index, self.scfg, self.make, self.depth = index, scfg, make, depth
        self.inflight = collections.deque()
        self.next_i = 0
        self.errors = 0
        self.attempted = 0      # queries dispatched
        self.failed = 0         # queries whose finalize raised

    def dispatch(self) -> int:
        i = self.next_i
        self.next_i += 1
        q = self.make(i)
        t = time.perf_counter()
        h = self.search.mih_search_dispatch(self.index, q, self.scfg)
        if h is None:
            raise RuntimeError("the fused driver declined the cell's "
                               "request")
        self.inflight.append((i, t, q.shape[0], h))
        self.attempted += q.shape[0]
        return i

    def finalize(self):
        """``(i, dispatched, returned, n_queries, result or None)`` of the
        oldest batch in flight; a batch whose finalize raises has no
        result."""
        i, t, n, h = self.inflight.popleft()
        try:
            res = self.search.mih_search_finalize(h)
        except Exception:  # the loop must go on: the batch counts failed
            self.errors += 1
            self.failed += n
            if self.errors == 1:
                log(traceback.format_exc())
            res = None
        return i, t, time.perf_counter(), n, res

    def fill(self) -> None:
        while len(self.inflight) < self.depth:
            self.dispatch()

    def turn(self):
        """Finalize the oldest batch and dispatch the next."""
        out = self.finalize()
        self.dispatch()
        return out

    def drain(self) -> list:
        return [self.finalize() for _ in range(len(self.inflight))]


@dataclasses.dataclass
class Window:
    """What the measured window finished: batches whose finalize returned
    before its close."""

    t0: float = 0.0
    t_last: float = 0.0
    batches: int = 0
    queries: int = 0
    cands: int = 0
    latencies: List[float] = dataclasses.field(default_factory=list)

    @property
    def span_s(self) -> float:
        """From the first timed dispatch to the last answer of the window."""
        return self.t_last - self.t0


def measure(loop: Loop, seconds: float, keeper: Keeper) -> Window:
    """The window: fill the loop, then finalize the oldest batch and
    dispatch the next, until an answer returns past the close; the loop
    is left full."""
    w = Window(t0=time.perf_counter())
    close = w.t0 + seconds
    loop.fill()
    while True:
        i, t, t1, n, res = loop.turn()
        if t1 > close:
            return w
        if res is not None:
            w.batches += 1
            w.queries += n
            w.t_last = t1
            w.latencies.append(t1 - t)
            w.cands += int(res.n_cands.sum())
            keeper.take(i, res)


# --------------------------------------------------------------------------
# A run
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers take it."""

    cell: spec_lib.Cell
    device: torch.device
    seed: int
    n_codes: int
    setup_s: float = 0.0
    build_s: float = 0.0
    window: Optional[Window] = None
    peak_bytes: int = 0
    trace: Optional[trace_lib.Trace] = None
    corpus: Optional[torch.Tensor] = None

    def probe_batch(self, n: int) -> torch.Tensor:
        """``n`` queries of the cell's traffic that no window sends."""
        return gen.batch(self.cell.traffic, self.seed, 0, self.corpus, n,
                         stream=gen.PROBE)


def search_config(cell: spec_lib.Cell):
    from verticut_tpu_torch.config import SearchConfig
    c = cell.config["search"]
    return SearchConfig(knn=int(cell.traffic["k"]),
                        candidate_cap=int(c["candidate_cap"]),
                        max_enum_radius=int(c["max_enum_radius"]))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(fields: str = "name,power.limit") -> str:
    """``nvidia-smi``'s reading of ``fields`` for the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unreadable"
    return out[0].strip() if out else "nvidia-smi unreadable"


def run_cell(cell: spec_lib.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, control: Optional[str] = None,
             t_start: float = T_START) -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict."""
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index import build_index

    cfg = cell.config
    run = Run(cell=cell, device=device, seed=seed,
              n_codes=int(cfg["n_codes"]))
    t_gen = time.perf_counter()
    corpus = gen.corpus(cfg, seed, device)
    sync(device)
    t0 = time.perf_counter()
    index = build_index(corpus, MIHConfig(bits=int(cfg["bits"]),
                                          n_tables=int(cfg["n_tables"])),
                        device=device, store_codes=cfg["layout"] == "inline",
                        keep_entry_ids=False)
    sync(device)
    run.build_s = time.perf_counter() - t0
    run.corpus = corpus
    scfg = search_config(cell)
    depth = int(cell.traffic["depth"])
    q = cell.batch

    warm = Loop(index, scfg, lambda i: gen.batch(
        cell.traffic, seed, i, corpus, q, stream=gen.WARMUP), depth)
    warm.fill()
    while warm.next_i < WARMUP_BATCHES:
        warm.turn()
    warm.drain()
    if warm.errors:
        raise RuntimeError("the warm-up batches failed")
    sync(device)

    loop = Loop(index, scfg, lambda i: gen.batch(cell.traffic, seed, i,
                                                 corpus, q), depth)
    keeper = Keeper(seed, scfg.knn, int(cfg["n_tables"]))
    t_win = time.perf_counter()
    run.setup_s = t_win - t_start
    run.window = measure(loop, seconds, keeper)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
        log("bench: card at the close: "
            + card("clocks.sm,temperature.gpu,power.draw"))
    log(f"bench: {cell.name} seed {seed}: set-up {run.setup_s:.2f} s "
        f"(start and imports {t_gen - t_start:.2f}, corpus {t0 - t_gen:.2f},"
        f" build {run.build_s:.2f}, warm-up "
        f"{t_win - t0 - run.build_s:.2f}), {run.window.batches} batches, "
        f"{run.window.queries} queries in {run.window.span_s:.3f} s, peak "
        f"{run.peak_bytes} B")

    if trace:
        run.trace = trace_lib.traced(lambda: loop.turn()[4] is not None,
                                     TRACE_BATCHES, device.type == "cuda",
                                     settle=depth)
    metrics = spec_lib.read_metrics(
        cell.per_layer if trace else cell.end_to_end, run)
    loop.drain()
    sample = keeper.sample()
    attempted, failed = loop.attempted, loop.failed

    del index, loop, warm, corpus
    run.corpus = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = check(cell, seed, device, sample, failed, control)

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise RuntimeError(f"the process holds {found} after the window")
    out = {"correct": all(v <= lim for v, lim in compared.values()),
           "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": run.peak_bytes}}
    if trace:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    if device.type == "cuda":
        out["card"] = card()
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, (v, lim) in compared.items()}
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=CONTROLS, default=None,
                   help="tail: hold the reference over all but the end of "
                   "the corpus in the program's place")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    cell = spec_lib.load_cell(args.workload)
    multi = "mesh" in cell.config
    if multi:
        from benchmark import multicard
        why = multicard.refusal(cell)
        if why:
            log(f"bench: {why}")
            return 2
    if not torch.cuda.is_available():
        log("bench: torch.cuda.is_available() is False; the benchmark "
            "measures a CUDA card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"bench: {args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    if multi:
        out = multicard.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), T_START,
                                 control=args.control)
        if out is None:
            return 1
    else:
        torch.set_num_threads(THREADS)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), control=args.control)
    for name, c in out["compared"].items():
        log(f"compared {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
