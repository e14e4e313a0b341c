"""The port's benchmark: batched exact MIH K-NN on one CUDA card, under the
protocol of the reference's ``bench.py``.

Run on a machine with an NVIDIA GPU:

    python -m verticut_tpu_torch.bench [N]

It prints one JSON line (``metric``, ``value``, ``unit``, ``vs_baseline``,
``extra``) and exits non-zero without CUDA, or when the oracle cell finds a
wrong answer. ``N``, the corpus size, overrides ``VERTICUT_BENCH_N``
(``python -m verticut_tpu_torch.bench 1000000000`` serves 1B codes from one
H100 in the compact layout). Environment, as the reference reads it:

* ``VERTICUT_BENCH_N`` corpus size (1,000,000), ``VERTICUT_BENCH_Q`` batch
  size (8192), ``VERTICUT_BENCH_K`` k (10);
* ``VERTICUT_BENCH_ORACLE`` queries held against the popcount oracle, dists
  and ids (64; 0 turns the cell off);
* ``VERTICUT_BENCH_CELLS`` "0" skips the k = 100 and uniform-query cells;
* ``VERTICUT_DEVICE_BUILD_MIN`` corpus size from which the corpus is
  generated on the card and the flat id columns are dropped (20,000,000).

Protocol: clustered 128-bit codes (``n // 200`` clusters, flip rate
0.02), ``MIHConfig(bits=128, n_tables=4)``, ``SearchConfig(candidate_cap=
8192, max_enum_radius=5)``, queries = corpus rows with 3 random bit flips;
one warm-up batch, three latency batches, then 12 batches through a
depth-4 ``mih_search_dispatch`` / ``mih_search_finalize`` pipeline (8 for
the k = 100 and uniform cells). Below ``VERTICUT_DEVICE_BUILD_MIN`` the
corpus is made on the host (the reference's ``clustered_codes``); from it
up, on the card (``clustered_codes_device``), with the inline layout while
its rows fit 10 GiB and the compact one beyond, as the reference picks.
The cell functions take an explicit ``device``, so they also run on the CPU
at a small size.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import codes
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.search import (linear_search, mih_search,
                                       mih_search_dispatch,
                                       mih_search_finalize)

CFG = MIHConfig(bits=128, n_tables=4)
DEVICE_BUILD_MIN = 20_000_000
# the reference's inline budget: rows of ~21 B per entry and table
INLINE_MAX_BYTES = 10 * (1 << 30)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def perturbed_queries(rng: np.random.Generator, corpus: torch.Tensor,
                      n_queries: int, n_flips: int = 3) -> torch.Tensor:
    """Random rows of ``corpus`` (``int32[N, W]``) with ``n_flips`` random
    bit flips each, on the corpus's device. The row and bit choices are
    the reference's numpy draws (``rng.integers`` for the rows, then for
    the bits), so a host corpus and a device corpus give the same queries;
    a position drawn twice cancels."""
    n, w = corpus.shape
    dev = corpus.device
    sel = torch.from_numpy(rng.integers(0, n, n_queries)).to(dev)
    pos = torch.from_numpy(rng.integers(0, 32 * w, (n_queries, n_flips)))
    word, bit = (pos // 32).to(dev), (pos % 32).to(dev)
    out = corpus[sel].clone()
    rows = torch.arange(n_queries, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    for j in range(n_flips):
        x = one << bit[:, j]                   # as an int32 bit pattern
        out[rows, word[:, j]] ^= torch.where(x >= 1 << 31, x - (1 << 32),
                                             x).to(torch.int32)
    return out


def make_index(n: int, device, device_build_min: int = DEVICE_BUILD_MIN,
               cfg: MIHConfig = CFG):
    """The benchmark's corpus and index on ``device``; returns ``(index,
    info)`` with the generation and build seconds and the layout."""
    t0 = time.perf_counter()
    if n >= device_build_min:
        corpus = codes.clustered_codes_device(
            0, n, cfg.bits, n_clusters=max(1, n // 200), flip_p=0.02,
            device=device)
    else:
        corpus = bits_lib.as_codes(codes.clustered_codes(
            0, n, cfg.bits, n_clusters=max(1, n // 200), flip_p=0.02))
    sync(device)
    gen_s = time.perf_counter() - t0
    inline = n * 21 * cfg.n_tables <= INLINE_MAX_BYTES
    t0 = time.perf_counter()
    index = build_index(corpus, cfg, device=device, store_codes=inline,
                        keep_entry_ids=n < DEVICE_BUILD_MIN)
    sync(device)
    build_s = time.perf_counter() - t0
    del corpus
    log(f"bench: N={n} generated in {gen_s:.1f} s "
        f"({'card' if n >= device_build_min else 'host'}), built in "
        f"{build_s:.2f} s ({'inline' if inline else 'compact'} rows)")
    return index, {"gen_s": gen_s, "build_s": build_s,
                   "layout": "inline" if inline else "compact"}


def latency(index, queries, scfg: SearchConfig, runs: int = 3):
    """A warm-up batch, then ``runs`` timed single batches (``mih_search``,
    ending in a device sync). Returns ``(warm-up s, [run s], result)``."""
    dev = index.device
    t0 = time.perf_counter()
    res = mih_search(index, queries, scfg)
    sync(dev)
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        res = mih_search(index, queries, scfg)
        sync(dev)
        times.append(time.perf_counter() - t0)
    return warmup_s, times, res


def pipelined(index, queries, scfg: SearchConfig, n_batches: int,
              depth: int = 4):
    """Seconds per batch over ``n_batches`` batches kept ``depth`` deep in
    flight through dispatch / finalize, and the last batch's result and
    handle; None when the fused driver declines the request."""
    if n_batches < depth:
        raise ValueError("the window must cover at least `depth` batches")
    t0 = time.perf_counter()
    first = mih_search_dispatch(index, queries, scfg)
    if first is None:
        return None
    window = [first]
    for _ in range(depth - 1):
        window.append(mih_search_dispatch(index, queries, scfg))
    for _ in range(n_batches - depth):
        res = mih_search_finalize(window.pop(0))
        window.append(mih_search_dispatch(index, queries, scfg))
    while window:
        handle = window.pop(0)
        res = mih_search_finalize(handle)
    return (time.perf_counter() - t0) / n_batches, res, handle


def oracle_check(index, queries, scfg: SearchConfig, res=None) -> dict:
    """``mih_search`` on ``queries`` against the popcount oracle over the
    whole corpus: dists and ids equal, the distance multisets equal, and
    every returned id's true distance equal to the returned one. ``res``
    is an already computed result for these queries."""
    if res is None:
        res = mih_search(index, queries, scfg)
    t0 = time.perf_counter()
    od, oi = linear_search(queries, index.codes, scfg.knn,
                           method="popcount")
    od, oi = od.cpu(), oi.cpu()
    scan_s = time.perf_counter() - t0
    ids = res.ids.to(index.device).long().clamp(min=0)
    true_d = codes.hamming_distance(index.codes[ids],
                                    queries[:, None, :]).cpu()
    return {
        "oracle_queries": queries.shape[0],
        "oracle_scan_s": scan_s,
        "oracle_dists_equal": bool(torch.equal(res.dists, od)),
        "oracle_ids_equal": bool(torch.equal(res.ids, oi)),
        "oracle_multiset_equal": bool(torch.equal(
            torch.sort(res.dists, -1).values, torch.sort(od, -1).values)),
        "id_dist_equal": bool(((true_d == res.dists) | (res.ids < 0)).all()),
    }


def oracle_ok(rec: dict) -> bool:
    return all(rec[f] for f in ("oracle_dists_equal", "oracle_ids_equal",
                                "oracle_multiset_equal", "id_dist_equal"))


def cell(index, queries, scfg: SearchConfig, n_batches: int,
         latency_runs: int) -> dict:
    """One cell: warm-up, latency runs, the pipelined batches."""
    warmup_s, times, res = latency(index, queries, scfg, latency_runs)
    pipe = pipelined(index, queries, scfg, n_batches)
    dt = min(times) if pipe is None else pipe[0]
    return {"warmup_s": warmup_s, "latency_s": times,
            "batch_latency_s": min(times), "pipelined_batch_s": dt,
            "qps": queries.shape[0] / dt, "result": res,
            "handle": None if pipe is None else pipe[2]}


def run(n: int, q_batch: int, k: int, device, oracle_nq: int = 64,
        cells: bool = True, device_build_min: int = DEVICE_BUILD_MIN,
        n_batches: int = 12, latency_runs: int = 3) -> dict:
    """The whole benchmark on ``device``: the record the JSON line prints,
    minus the device fields. ``n_batches`` and ``latency_runs`` are the
    headline cell's; the k = 100 and uniform cells take one latency run
    and ``min(8, n_batches)`` pipelined batches."""
    rng = np.random.default_rng(0)
    index, info = make_index(n, device, device_build_min)
    queries = perturbed_queries(rng, index.codes, q_batch)
    scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
    head = cell(index, queries, scfg, n_batches, latency_runs)
    res = head["result"]
    log(f"bench: warm-up {head['warmup_s']:.2f} s, radii "
        f"{torch.bincount(res.radius).tolist()}, latency "
        f"{head['batch_latency_s']:.4f} s, pipelined "
        f"{head['pipelined_batch_s']:.4f} s/batch")
    if not bool((res.dists[:, 0] <= 3).all()):
        raise RuntimeError("bench: a planted neighbour was missed")
    extra = {"n_codes": n, "q_batch": q_batch, "k": k,
             "batch_latency_s": head["batch_latency_s"],
             "pipelined_batch_s": head["pipelined_batch_s"],
             "gen_s": info["gen_s"], "build_s": info["build_s"],
             "layout": info["layout"], "warmup_s": head["warmup_s"],
             "mean_radius": float(res.radius.float().mean()),
             "mean_probes": float(res.n_probes.float().mean()),
             "mean_cands": float(res.n_cands.float().mean())}
    if oracle_nq:
        extra.update(oracle_check(index, queries[:oracle_nq], scfg))
    if cells:
        scfg100 = SearchConfig(knn=100, candidate_cap=8192, max_enum_radius=5)
        side = min(8, n_batches)
        c100 = cell(index, queries, scfg100, side, latency_runs=1)
        extra["k100_qps"] = c100["qps"]
        extra["k100_batch_latency_s"] = c100["batch_latency_s"]
        uq = bits_lib.as_codes(codes.random_codes(99, q_batch, CFG.bits),
                               device)
        cu = cell(index, uq, scfg, side, latency_runs=1)
        extra["uniform_q_qps"] = cu["qps"]
        extra["uniform_batch_latency_s"] = cu["batch_latency_s"]
        extra["uniform_mean_radius"] = float(
            cu["result"].radius.float().mean())
    qps = head["qps"]
    return {"metric": "mih_exact_qps_per_chip", "value": qps,
            "unit": "queries/s", "vs_baseline": qps / 1e6, "extra": extra}


def card() -> dict:
    """The card's name and power limit (``nvidia-smi``)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.strip().splitlines()[0]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        log("bench: torch.cuda.is_available() is False; the benchmark "
            "measures a CUDA card")
        return 2
    env = os.environ
    rec = run(n=int(argv[0] if argv else env.get("VERTICUT_BENCH_N",
                                                 1_000_000)),
              q_batch=int(env.get("VERTICUT_BENCH_Q", 8192)),
              k=int(env.get("VERTICUT_BENCH_K", 10)),
              device=torch.device("cuda", 0),
              oracle_nq=int(env.get("VERTICUT_BENCH_ORACLE", 64)),
              cells=env.get("VERTICUT_BENCH_CELLS", "1") != "0",
              device_build_min=int(env.get("VERTICUT_DEVICE_BUILD_MIN",
                                           DEVICE_BUILD_MIN)))
    rec["extra"].update(card())
    print(json.dumps(rec), flush=True)
    if "oracle_queries" in rec["extra"] and not oracle_ok(rec["extra"]):
        log("bench: the oracle cell found a wrong answer")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
