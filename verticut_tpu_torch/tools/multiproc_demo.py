"""Multi-process demo of the compact sharded engine: the port's twin of
``tools/multiproc_demo.py``, in a world of one process per device.

The reference's multi-host seam is real processes on real machines —
``mpirun -n N -hostfile`` workers (src/run_distributed_search.py:74-85)
and ssh-dispatched jobs (src/image_search_server.cc:58-83). The port's
multi-device engines are SPMD on ``torch.distributed`` with one process
per device, so the demo runs ``T*S*Q`` processes (``tools/_mesh.py``:
under ``torchrun``, or spawned by ``parallel.world.spawn``): NCCL with one
card per rank, or gloo CPU processes with ``--device cpu``. Everything
that breaks across processes breaks here first: per-rank corpus slices,
cross-process collectives, per-rank shard persistence, barriers.

The demo, the JAX tool's protocol (artifact ``MULTIPROC_torch.json`` by
default; the JAX package's ``MULTIPROC_r05.json`` is its own):

  1. build a compact sharded index on the mesh (default table=4, shard=2,
     query=1) over 200,000 clustered 128-bit codes,
  2. run the fused sharded search of 64 queries (corpus rows with 3 bit
     flips each, ``default_rng(5)``) at k = 10,
  3. assert distance-multiset equality with a process-local brute-force
     oracle, and that every returned id lies at its returned distance,
  4. save every rank's shards to one directory, barrier, reload, and
     re-run the search on the loaded index (checkpoint/resume seam): dists
     and ids must equal the first answer.

Usage:
  python -m verticut_tpu_torch.tools.multiproc_demo        # 8 cards
  python -m verticut_tpu_torch.tools.multiproc_demo --mesh 1x1x1
  python -m verticut_tpu_torch.tools.multiproc_demo --device cpu

The JAX launcher's ``--proc`` and ``--nprocs`` are its worker protocol
(processes of 4 virtual devices each); here the world has one process per
device of ``--mesh``. On a host with fewer cards than the mesh has devices
the tool raises and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

N_CODES = 200_000
N_QUERIES = 64
KNN = 10


def demo(mesh, save_dir: str):
    """Every rank of ``mesh``: the demo's four steps; rank 0 returns the
    artifact's record, the others ``None``."""
    import torch
    import torch.distributed as dist

    from verticut_tpu_torch import codes
    from verticut_tpu_torch.bench import sync
    from verticut_tpu_torch.bits import as_codes
    from verticut_tpu_torch.config import MIHConfig, SearchConfig
    from verticut_tpu_torch.search.linear import linear_search
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, load_sharded_compact, save_sharded_compact,
        sharded_compact_search)

    dev = mesh.device
    n_global = dist.get_world_size()
    t_all = time.time()

    cfg = MIHConfig(bits=128, n_tables=4)
    # identical host-side corpus in every process (deterministic seed) —
    # the build shards it by id across the mesh
    packed = codes.clustered_codes(0, N_CODES, cfg.bits,
                                   n_clusters=N_CODES // 200, flip_p=0.02)
    rng = np.random.default_rng(5)
    sel = rng.integers(0, N_CODES, N_QUERIES)
    qraw = codes.unpack_to_bytes(packed[sel])
    flips = rng.integers(0, cfg.bits, (N_QUERIES, 3))
    for i in range(N_QUERIES):
        for b in flips[i]:
            qraw[i, b // 8] ^= 1 << (b % 8)
    queries = codes.pack_bytes(qraw)

    t0 = time.time()
    index = build_sharded_compact(packed, cfg, mesh)
    sync(dev)
    build_s = time.time() - t0

    scfg = SearchConfig(knn=KNN, candidate_cap=4096, max_enum_radius=5)
    t0 = time.time()
    res = sharded_compact_search(index, queries, scfg)
    search_s = time.time() - t0
    dists, ids = res.dists.numpy(), res.ids.numpy()

    # process-local oracle (no collectives): exact top-k per query
    od, _ = linear_search(as_codes(queries, dev), as_codes(packed, dev),
                          KNN)
    multiset_ok = bool(np.array_equal(np.sort(dists, axis=-1),
                                      np.sort(od.cpu().numpy(), axis=-1)))
    # id->dist cross-check: every returned id's true distance matches
    qb = np.unpackbits(codes.unpack_to_bytes(queries), axis=-1)
    rb = np.unpackbits(codes.unpack_to_bytes(
        packed[np.clip(ids, 0, N_CODES - 1)].reshape(-1, cfg.n_words)
    ), axis=-1).reshape(N_QUERIES, KNN, -1)
    true_d = (qb[:, None, :] != rb).sum(-1)
    id_dist_ok = bool(np.all((ids < 0) | (true_d == dists)))

    # persistence seam: each rank writes only its own shards (the save
    # returns once every rank has written)
    save_sharded_compact(save_dir, index)
    index2 = load_sharded_compact(save_dir, mesh)
    res2 = sharded_compact_search(index2, queries, scfg)
    reload_ok = bool(torch.equal(res2.dists, res.dists)
                     and torch.equal(res2.ids, res.ids))

    if dist.get_rank() != 0:
        return None
    files = sorted(os.listdir(save_dir))
    kind = (f"cuda ({n_global} processes x 1 device, nccl: "
            f"{torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
            else f"cpu ({n_global} processes x 1 device, gloo)")
    return {
        "metric": "multiproc_compact_demo",
        "ok": bool(multiset_ok and id_dist_ok and reload_ok),
        "n_processes": n_global,
        "local_devices_per_process": 1,
        "global_devices": n_global,
        "mesh": dict(mesh.shape),
        "n_codes": N_CODES,
        "n_queries": N_QUERIES,
        "knn": KNN,
        "oracle_multiset_equal": multiset_ok,
        "id_dist_equal": id_dist_ok,
        "save_load_roundtrip_equal": reload_ok,
        "n_shard_files": len([f for f in files if f.endswith(".npy")]),
        "build_s": round(build_s, 2),
        "search_s": round(search_s, 2),
        "total_s": round(time.time() - t_all, 2),
        "platform": kind,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default="4x2x1",
                    help="TxSxQ: one process per device (default 4x2x1)")
    ap.add_argument("--save-dir", default="",
                    help="directory of the shards (default: a temporary "
                         "one, removed at the end; needed under torchrun)")
    ap.add_argument("--out", default="MULTIPROC_torch.json")
    ap.add_argument("--device", default=None,
                    help="cpu for a gloo world (default: the card, one per "
                         "rank)")
    args = ap.parse_args(argv)

    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.tools import _mesh

    shape = _mesh.parse(args.mesh)
    device = entry_device(args.device)
    if "WORLD_SIZE" in os.environ and not args.save_dir:
        raise ValueError("under torchrun every rank runs main(): give the "
                         "ranks one --save-dir")
    save_dir = args.save_dir or tempfile.mkdtemp(prefix="vt_multiproc_")
    try:
        payload = _mesh.run(demo, shape, device, save_dir)
    finally:
        if not args.save_dir:
            shutil.rmtree(save_dir, ignore_errors=True)
    if payload is None:          # a torchrun rank other than 0
        return None
    with open(args.out, "w") as f:
        f.write(json.dumps(payload) + "\n")
    print(json.dumps(payload), flush=True)
    return payload


if __name__ == "__main__":
    main()
