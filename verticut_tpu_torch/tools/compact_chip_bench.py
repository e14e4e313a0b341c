"""The compact (1B-scale) sharded layout on one device: the port's twin of
``tools/compact_chip_bench.py``.

``build_sharded_compact`` and ``sharded_compact_search`` (id-only blocked
rows over a shared code array, built per device) in a world of one
process (``parallel.single_device_mesh``: NCCL on the card, gloo on the
CPU), mesh (table=1, shard=1, query=1): how each device of a mesh would
hold its slice at 1B. The protocol is the JAX tool's: N clustered codes
made on the device, Q = 8192 perturbed-row queries (3 bit flips,
``default_rng(0)``), k = 10, a warm-up batch (every planted neighbour
found within distance 3), then 4 timed batches (each call synchronous:
the compact engine has no dispatch / finalize split, so the row is
single-batch latency), then 32 queries against the independent sharded
linear scan (distance multisets equal).

Its artifact is ``BENCH_100M_COMPACT_torch.json`` by default (the JAX
package's ``BENCH_100M_COMPACT_r05.json`` is its own). The corpus comes
from the port's device generator, whose stream is not ``jax.random``'s:
``mean_radius`` is that corpus's.

Usage: python -m verticut_tpu_torch.tools.compact_chip_bench [N]
[out.json] [--q 8192] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from verticut_tpu_torch import bench, codes
from verticut_tpu_torch.bits import entry_device
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.parallel import single_device_mesh
from verticut_tpu_torch.parallel.world import close_world
from verticut_tpu_torch.search.sharded import sharded_linear_search
from verticut_tpu_torch.search.sharded_compact import (build_sharded_compact,
                                                       sharded_compact_search)
from verticut_tpu_torch.tools._profile import log

K = 10
N_ORACLE = 32


def run(n: int, q_batch: int, device) -> dict:
    """The bench in a world of one on ``device``: the artifact's record."""
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = single_device_mesh(device)
    dev = mesh.device
    out = {"metric": "compact_chip_bench", "n": n, "q_batch": q_batch,
           "k": K, "mesh": {"table": 1, "shard": 1, "query": 1},
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    t0 = time.time()
    packed = codes.clustered_codes_device(0, n, cfg.bits,
                                          n_clusters=max(1, n // 200),
                                          flip_p=0.02, device=dev)
    bench.sync(dev)
    out["gen_s"] = time.time() - t0
    t0 = time.time()
    index = build_sharded_compact(packed, cfg, mesh, slack=1.5)
    bench.sync(dev)
    out["build_s"] = time.time() - t0
    out["memory_stats"] = index.memory_stats()
    log(f"compact: gen {out['gen_s']:.1f}s build {out['build_s']:.1f}s "
        f"stats={out['memory_stats']}")
    queries = bench.perturbed_queries(np.random.default_rng(0), packed,
                                      q_batch)
    del packed
    scfg = SearchConfig(knn=K, candidate_cap=8192, max_enum_radius=5)
    t0 = time.time()
    res = sharded_compact_search(index, queries, scfg)
    out["warmup_s"] = time.time() - t0
    out["mean_radius"] = float(res.radius.double().mean())
    out["planted_found"] = bool((res.dists[:, 0] <= 3).all())
    log(f"compact: warmup {out['warmup_s']:.1f}s mean_radius="
        f"{out['mean_radius']}")
    times = []
    for _ in range(4):
        t0 = time.time()
        res = sharded_compact_search(index, queries, scfg)
        times.append(time.time() - t0)
        log(f"compact: batch {times[-1]:.3f}s")
    out["batch_latency_s"] = min(times)
    out["qps_single_batch"] = q_batch / min(times)
    t0 = time.time()
    ld, _ = sharded_linear_search(mesh, index.codes, queries[:N_ORACLE], K,
                                  n_total=n)
    out["oracle_s"] = time.time() - t0
    out["oracle_queries"] = N_ORACLE
    out["oracle_multiset_equal"] = bool(torch.equal(
        torch.sort(ld.cpu(), -1).values,
        torch.sort(res.dists[:N_ORACLE], -1).values))
    out["ok"] = out["oracle_multiset_equal"] and out["planted_found"]
    log(f"compact: oracle equal={out['oracle_multiset_equal']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", type=int, nargs="?", default=100_000_000)
    ap.add_argument("out", nargs="?", default="BENCH_100M_COMPACT_torch.json")
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    try:
        out = run(args.n, args.q, dev)
    finally:
        close_world()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    if not out["ok"]:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
