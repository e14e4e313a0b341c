"""Multi-config perf sweep with min/avg/stddev/max aggregation: the
port's twin of ``tools/perf_sweep.py``, with the same modes, flags, rows
and ``--out`` file, plus ``--device`` for the search mode.

The reference drives its benchmarks through ~2.2k LoC of Python perftest
harnesses (``Pilaf/pilaf_perftest.py``, ``ib_perftest.py``,
``tcp_echo/perftest.py``): restart servers, fan out mpirun clients over a
hostfile, scrape stdout numbers, aggregate min/avg/stddev/max per config
cell. One process owns the card here, so the fan-out collapses to
in-process repeats — what remains, and what this tool provides, is the
sweep grid + repeat + aggregate + machine-readable report layer.

Modes:
  search  — MIH search throughput over a (n, q, k) grid (the
            distributed_image_search sweep), on the card unless
            ``--device`` names another device; each timed search ends in
            the device's synchronisation.
  kv      — KV store op throughput over a (backend, value-size) grid
            (the ploadtest sweep).
  echo    — TCP echo RTT (the tcp_echo control).

Usage:
    python -m verticut_tpu_torch.tools.perf_sweep search --n 100000 \
        --q 512,2048 --k 10,100 --repeats 3 --out sweep.json
    python -m verticut_tpu_torch.tools.perf_sweep kv \
        --backends memory,native --sizes 64,1024
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def _agg(vals):
    return {
        "min": round(min(vals), 2), "avg": round(statistics.mean(vals), 2),
        "stddev": round(statistics.pstdev(vals), 2),
        "max": round(max(vals), 2), "n_runs": len(vals),
    }


def sweep_search(args) -> list:
    import numpy as np
    from verticut_tpu_torch import codes
    from verticut_tpu_torch.bench import sync
    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.config import MIHConfig, SearchConfig
    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.search import mih_search

    device = entry_device(args.device)
    rows = []
    for n in args.n:
        cfg = MIHConfig(bits=128, n_tables=4)
        packed = codes.clustered_codes(0, n, cfg.bits,
                                       n_clusters=max(8, n // 200),
                                       flip_p=0.02)
        idx = build_index(packed, cfg, directory="range", device=device)
        rng = np.random.default_rng(1)
        for q in args.q:
            queries = packed[rng.integers(0, n, q)]
            for k in args.k:
                scfg = SearchConfig(knn=k, candidate_cap=8192)
                mih_search(idx, queries, scfg)      # warm-up
                sync(device)
                qps = []
                for _ in range(args.repeats):
                    t0 = time.time()
                    mih_search(idx, queries, scfg)
                    sync(device)
                    qps.append(q / (time.time() - t0))
                row = {"cell": {"n": n, "q": q, "k": k},
                       "qps": _agg(qps)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def sweep_kv(args) -> list:
    from verticut_tpu_torch.kv.store import make_store

    rows = []
    for backend in args.backends:
        for size in args.sizes:
            val = b"v" * size
            ops = args.ops
            thr_put, thr_get = [], []
            for _ in range(args.repeats):
                store = make_store(backend)
                keys = [b"k%08d" % i for i in range(ops)]
                t0 = time.time()
                for kb in keys:
                    store.put(kb, val)
                thr_put.append(ops / (time.time() - t0))
                t0 = time.time()
                for kb in keys:
                    assert store.get(kb) == val
                thr_get.append(ops / (time.time() - t0))
                close = getattr(store, "close", None)
                if close:
                    close()
            row = {"cell": {"backend": backend, "value_size": size,
                            "ops": ops},
                   "put_ops_per_s": _agg(thr_put),
                   "get_ops_per_s": _agg(thr_get)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def sweep_echo(args) -> list:
    from verticut_tpu_torch.tools.tcp_echo import EchoServer, run_client

    rows = []
    for _ in range(args.repeats):
        srv = EchoServer().start()
        try:
            rows.append(run_client("127.0.0.1", srv.port,
                                   iters=args.ops, max_log2=args.max_log2))
        finally:
            srv.stop()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)

    def ints(s):
        return [int(x) for x in s.split(",")]

    s1 = sub.add_parser("search")
    s1.add_argument("--n", type=ints, default=[100_000])
    s1.add_argument("--q", type=ints, default=[512])
    s1.add_argument("--k", type=ints, default=[10, 100])
    s1.add_argument("--repeats", type=int, default=3)
    s1.add_argument("--out")
    s1.add_argument("--device", default=None,
                    help="device to search on (default: the card)")

    s2 = sub.add_parser("kv")
    s2.add_argument("--backends", type=lambda s: s.split(","),
                    default=["memory"])
    s2.add_argument("--sizes", type=ints, default=[64, 1024])
    s2.add_argument("--ops", type=int, default=20_000)
    s2.add_argument("--repeats", type=int, default=3)
    s2.add_argument("--out")

    s3 = sub.add_parser("echo")
    s3.add_argument("--ops", type=int, default=500)
    s3.add_argument("--max-log2", dest="max_log2", type=int, default=12)
    s3.add_argument("--repeats", type=int, default=1)
    s3.add_argument("--out")

    args = ap.parse_args(argv)
    rows = {"search": sweep_search, "kv": sweep_kv,
            "echo": sweep_echo}[args.mode](args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mode": args.mode, "rows": rows}, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
