"""Pipeline depth against the result copy: the port's twin of
``tools/pipeline_overlap_bench.py``.

Batches of 8192 perturbed queries at k = 10 and 100 through
``mih_search_dispatch`` / ``mih_search_finalize``, kept 2 and 4 deep in
flight (``k{k} depth{d}``: ms per batch over 10 batches, the best of three
runs), and the copy of a ready ``int32[8192, 107]`` row (3.5 MB, the k = 100
result) into pinned host memory (``d2h_3.5MB_ms``, the best of five).

The JAX tool's ``+async`` rows start the result's copy to the host at
dispatch (``copy_to_host_async()``) against not starting it. The port has
no such switch: since the dispatch worker came in, dispatch always starts
the row's copy into pinned memory behind a CUDA event
(``search/single._fused_worker``), so every row here is the JAX tool's
``+async`` protocol, and the JSON says so (``left_out``). Every finalized
batch must equal ``mih_search``'s answer (dists and ids), or the tool exits
1.

The JAX tool's size is fixed at 1M codes and 8192 queries; here ``--n``
and ``--q`` take those defaults.

Usage: python -m verticut_tpu_torch.tools.pipeline_overlap_bench
[--n 1000000] [--q 8192] [--device cpu]
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

LEFT_OUT = {
    f"k{k} depth{d}+async":
        "dispatch always starts the row's copy to pinned host memory "
        "behind an event (search/single._fused_worker); the rows without "
        "+async already run that protocol, and no switch turns it off"
    for k in (10, 100) for d in (2, 4)}


def d2h_ms(device, reps: int = 5) -> float:
    """The best of ``reps`` copies of a ready ``int32[8192, 107]`` tensor
    into host memory (pinned on the card), ms."""
    dev = torch.device(device)
    x = torch.arange(8192 * 107, dtype=torch.int32,
                     device=dev).reshape(8192, 107)
    host = torch.empty(x.shape, dtype=x.dtype,
                       pin_memory=dev.type == "cuda")
    bench.sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        host.copy_(x)
        bench.sync(dev)
        ts.append(time.perf_counter() - t0)
    if not torch.equal(host, x.cpu()):
        raise RuntimeError("d2h probe: the copy differs")
    return min(ts) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    _profile.log(f"overlap: building n={args.n}")
    index = bench.make_index(args.n, dev)[0]
    queries = _profile.perturbed(index, args.q)
    results, checks = {}, {}

    def run(k, depth, n_b=10):
        scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
        want = mih_search(index, queries, scfg)                 # warm-up
        ok, best = True, None

        def done(h):
            got = mih_search_finalize(h)
            return bool(torch.equal(got.dists, want.dists)
                        and torch.equal(got.ids, want.ids))

        for _ in range(3):
            t0 = time.time()
            window = [mih_search_dispatch(index, queries, scfg)
                      for _ in range(depth)]
            for _ in range(n_b - depth):
                ok &= done(window.pop(0))
                window.append(mih_search_dispatch(index, queries, scfg))
            while window:
                ok &= done(window.pop(0))
            dt = (time.time() - t0) / n_b
            best = dt if best is None else min(best, dt)
        name = f"k{k} depth{depth}"
        results[name] = best * 1e3
        checks[f"{name} every batch equals mih_search"] = ok
        _profile.log(f"  {name:24s} {best * 1e3:8.1f} ms/batch "
                     f"({args.q / best:,.0f} QPS)")

    results["d2h_3.5MB_ms"] = d2h_ms(dev)
    _profile.log(f"  d2h 3.5MB: {results['d2h_3.5MB_ms']:.3f} ms")
    for k in (10, 100):
        run(k, 2)
        run(k, 4)
    rec = {"metric": "pipeline_overlap", "ms": results, "n": args.n,
           "q": args.q, "checks": checks, "left_out": LEFT_OUT,
           "device": str(dev)}
    print(json.dumps(rec), flush=True)
    if _profile.fail_on(checks, "pipeline_overlap"):
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
