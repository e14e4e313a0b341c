"""Compact sharded build and search on a mesh, end to end: the port's twin
of ``tools/virtual_scale_run.py``.

The production distributed pipeline at one corpus size: N clustered codes
made on each rank's device (every rank makes the same corpus) ->
``build_sharded_compact`` on a (table, shard, query) mesh ->
``sharded_compact_search`` of 512 corpus rows (``default_rng(3)``) at
k = 10 -> the distance multisets of the first 32 against the independent
sharded linear scan -> ``save_sharded_compact`` / ``load_sharded_compact``
-> the 32 searched again on the loaded index. Rank 0 writes the artifact,
``VIRTUAL_SCALE_torch.json`` by default (the JAX package's
``VIRTUAL_SCALE_r04.json`` is its own).

The mesh is one process per device (``tools/_mesh.py``: under torchrun,
or spawned through ``parallel.world.spawn``). ``--device cpu`` is the JAX
tool's own setting: 8 gloo ranks on a (4, 2, 1) mesh. On the card it takes
``--mesh`` (default 4x2x1, one card per rank; a host with fewer cards
raises); a one-card machine runs ``--mesh 1x1x1``. The shards are saved
under ``VERTICUT_SCALE_SAVE`` if set, else in a temporary directory that
is removed afterwards.

Usage: python -m verticut_tpu_torch.tools.virtual_scale_run [N] [out.json]
[--mesh 4x2x1] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import tempfile
import time

import numpy as np

N_QUERIES = 512
KNN = 10
N_ORACLE = 32


def scale(mesh, n: int, save_dir: str):
    """Every rank of ``mesh``: the run's steps; rank 0 returns the
    artifact's record, the others ``None``."""
    import torch
    import torch.distributed as dist

    from verticut_tpu_torch import codes
    from verticut_tpu_torch.bench import sync
    from verticut_tpu_torch.config import MIHConfig, SearchConfig
    from verticut_tpu_torch.search.sharded import sharded_linear_search
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, load_sharded_compact, save_sharded_compact,
        sharded_compact_search)

    dev = mesh.device
    cfg = MIHConfig(bits=128, n_tables=4)
    out = {"metric": "virtual_scale_run", "n": n,
           "backend": (f"cuda ({dist.get_world_size()} processes, nccl)"
                       if dev.type == "cuda"
                       else f"cpu ({dist.get_world_size()} processes, gloo)"),
           "mesh": dict(mesh.shape), "k": KNN, "nq": N_QUERIES}
    t0 = time.time()
    packed = codes.clustered_codes_device(0, n, cfg.bits,
                                          n_clusters=max(2, n // 200),
                                          flip_p=0.02, device=dev)
    sync(dev)
    out["gen_s"] = time.time() - t0
    t0 = time.time()
    index = build_sharded_compact(packed, cfg, mesh, slack=1.5)
    sync(dev)
    out["build_s"] = time.time() - t0
    out["memory_stats"] = index.memory_stats()
    rng = np.random.default_rng(3)
    queries = packed[torch.from_numpy(rng.integers(0, n, N_QUERIES)).to(dev)]
    del packed

    t0 = time.time()
    res = sharded_compact_search(index, queries, SearchConfig(knn=KNN))
    out["search_s"] = time.time() - t0
    out["mean_radius"] = float(res.radius.double().mean())

    t0 = time.time()
    ld, _ = sharded_linear_search(mesh, index.codes, queries[:N_ORACLE], KNN,
                                  n_total=n)
    ed = torch.sort(res.dists[:N_ORACLE], -1).values
    out["oracle_q"] = N_ORACLE
    out["oracle_s"] = time.time() - t0
    out["oracle_multiset_equal"] = bool(torch.equal(
        torch.sort(ld.cpu(), -1).values, ed))

    t0 = time.time()
    save_sharded_compact(save_dir, index)
    out["save_s"] = time.time() - t0
    t0 = time.time()
    index2 = load_sharded_compact(save_dir, mesh)
    res2 = sharded_compact_search(index2, queries[:N_ORACLE],
                                  SearchConfig(knn=KNN))
    out["load_search_s"] = time.time() - t0
    out["load_multiset_equal"] = bool(torch.equal(
        torch.sort(res2.dists, -1).values, ed))
    dist.barrier()
    if dist.get_rank() != 0:
        return None
    out["save_bytes"] = sum(os.path.getsize(os.path.join(save_dir, f))
                            for f in os.listdir(save_dir))
    out["peak_rss_gb"] = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                          / (1 << 20))
    out["ok"] = out["oracle_multiset_equal"] and out["load_multiset_equal"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", type=int, nargs="?", default=64_000_000)
    ap.add_argument("out", nargs="?", default="VIRTUAL_SCALE_torch.json")
    ap.add_argument("--mesh", default="4x2x1",
                    help="TxSxQ: one process per device (default 4x2x1)")
    ap.add_argument("--device", default=None,
                    help="cpu for a gloo world (default: the card, one per "
                         "rank)")
    args = ap.parse_args(argv)

    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.tools import _mesh

    shape = _mesh.parse(args.mesh)
    device = entry_device(args.device)
    given = os.environ.get("VERTICUT_SCALE_SAVE")
    if "WORLD_SIZE" in os.environ and not given:
        raise ValueError("under torchrun every rank runs main(): give the "
                         "ranks one VERTICUT_SCALE_SAVE directory")
    save_dir = given or tempfile.mkdtemp(prefix="vt_scale_idx_")
    try:
        out = _mesh.run(scale, shape, device, args.n, save_dir)
    finally:
        if not given:
            shutil.rmtree(save_dir, ignore_errors=True)
    if out is None:              # a torchrun rank other than 0
        return None
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    print("wrote", args.out, "ok:", out["ok"], flush=True)
    if not out["ok"]:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
