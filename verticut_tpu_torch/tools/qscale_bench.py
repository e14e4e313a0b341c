"""Batch-size (Q) and pipeline-depth sweep of the fused driver: the port's
twin of ``tools/qscale_bench.py``.

For each k and batch size Q it prints, in ms per 8192 queries:

* ``prog_per8192_ms``: R = 6 batches dispatched back to back
  (``mih_search_dispatch``), then finalized; the time from the last
  dispatch's return to the last finalize, over R. Dispatch returns at once
  and the device's worker runs the batches one after another, so this is
  the worker's time per batch;
* ``d{depth} ms_per8192``: ``--batches`` batches kept ``depth`` deep in
  flight through dispatch / finalize, the better of two runs.

Every finalized batch must equal ``mih_search``'s answer on the same
queries (dists and ids), or the tool exits 1. A cell that raises is not
recorded and skipped, as in the JAX tool: the tool fails.

Usage: python -m verticut_tpu_torch.tools.qscale_bench [--n 1000000]
[--qs 8192 16384 32768] [--ks 10 100] [--depths 4 6] [--batches 12]
[--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from verticut_tpu_torch import bench
from verticut_tpu_torch.bits import entry_device
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                       mih_search_finalize)
from verticut_tpu_torch.tools import _profile

#: batches dispatched back to back for the program time
R = 6


def _equal(a, b) -> bool:
    return bool(torch.equal(a.dists, b.dists) and torch.equal(a.ids, b.ids))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--qs", type=int, nargs="+", default=[8192, 16384, 32768])
    ap.add_argument("--ks", type=int, nargs="+", default=[10, 100])
    ap.add_argument("--depths", type=int, nargs="+", default=[4, 6])
    ap.add_argument("--batches", type=int, default=12,
                    help="pipelined batches per measurement")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    _profile.log(f"qscale: building n={args.n}")
    index = bench.make_index(args.n, dev)[0]
    all_q = _profile.perturbed(index, max(args.qs))
    results, checks = {}, {}
    for k in args.ks:
        scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
        for q in args.qs:
            queries = all_q[:q]
            t0 = time.time()
            want = mih_search(index, queries, scfg)            # warm-up
            _profile.log(f"qscale: k={k} q={q} warm {time.time() - t0:.1f}s")
            ok = True
            mih_search_finalize(mih_search_dispatch(index, queries, scfg))
            hs = [mih_search_dispatch(index, queries, scfg) for _ in range(R)]
            t1 = time.time()
            for h in hs:
                ok &= _equal(mih_search_finalize(h), want)
            prog = (time.time() - t1) / R
            results[f"k{k} q{q} prog_per8192_ms"] = prog * 1e3 * 8192 / q
            for depth in args.depths:
                n_b = max(args.batches, depth + 2)
                best = None
                for _ in range(2):
                    t0 = time.time()
                    window = [mih_search_dispatch(index, queries, scfg)
                              for _ in range(depth)]
                    for _ in range(n_b - depth):
                        ok &= _equal(mih_search_finalize(window.pop(0)), want)
                        window.append(mih_search_dispatch(index, queries,
                                                          scfg))
                    while window:
                        ok &= _equal(mih_search_finalize(window.pop(0)), want)
                    dt = (time.time() - t0) / n_b
                    best = dt if best is None else min(best, dt)
                ms = best * 1e3 * 8192 / q
                results[f"k{k} q{q} d{depth} ms_per8192"] = ms
                _profile.log(f"qscale: k={k} q={q} depth={depth} "
                             f"{ms:.1f} ms/8192q = {8192 / ms * 1000:.0f} QPS")
            checks[f"k{k} q{q} every batch equals mih_search"] = ok
    rec = {"metric": "qscale", "n": args.n, "ms": results, "checks": checks,
           "device": str(dev)}
    print(json.dumps(rec), flush=True)
    if _profile.fail_on(checks, "qscale"):
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
