"""Transport microbenchmark — the ``Pilaf/ib-test.cc`` analog on the card.
The port's twin of ``tools/collective_bench.py``, with the same flags and
lines plus ``--device``.

The reference measures RDMA READ / 1-way verb / 2-way verb latency and
throughput over message sizes 2^0..2^17 (``ib-test.cc:43-44``). The port's
transports are (a) random gathers from device memory (the RDMA READ
analog: how fast the engine can fetch buckets) and (b) collectives over
the mesh's (table, shard) plane (``all_gather`` = the gather_vectors
transport). This tool sweeps the same size range and reports per-op
latency and bandwidth:

    python -m verticut_tpu_torch.tools.collective_bench [--max_pow 17]
    python -m verticut_tpu_torch.tools.collective_bench --mesh 1x1x1
    python -m verticut_tpu_torch.tools.collective_bench --mesh 4x2x1 --cpu

(a) gathers ``m`` int32 words from a table of 2^24 at indices drawn by
``np.random.default_rng(0)``, ``m`` = 1, 8, ... 2^max_pow. (b) runs in a
world of ``T*S*Q`` processes (``tools/_mesh.py``: under ``torchrun``, or
spawned): NCCL with one card per rank, or gloo with ``--cpu`` (the JAX
tool's virtual-CPU check). Each time is the mean of the timed calls after
one warm-up, ending in the device's synchronisation. Runs on the card
unless ``--cpu`` or ``--device`` names the CPU.
"""

import argparse
import time

import numpy as np
import torch


def timeit(fn, device, iters=20):
    from verticut_tpu_torch.bench import sync
    fn()  # warm-up
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters


def gather_sweep(device, max_pow):
    """``[(m, seconds)]``: one gather of ``m`` words from a 2^24-word
    table on ``device`` per size."""
    n = 1 << 24
    table = torch.arange(n, dtype=torch.int32, device=device)
    rows = []
    for pw in range(0, max_pow + 1, 3):
        m = 1 << pw
        idx = torch.from_numpy(
            np.random.default_rng(0).integers(0, n, m)).to(device)
        rows.append((m, timeit(lambda: table[idx], device)))
    return rows


def all_gather_sweep(mesh, max_pow):
    """On every rank of ``mesh``: ``[(m, seconds)]``, one ``all_gather``
    of this rank's ``[1, m]`` words over its (table, shard) plane per
    size."""
    from verticut_tpu_torch.parallel import collectives
    rows = []
    for pw in range(0, max_pow + 1, 3):
        m = 1 << pw
        x = torch.zeros((1, m), dtype=torch.int32, device=mesh.device)
        rows.append((m, timeit(
            lambda: collectives.gather_rows(x, mesh.model_group),
            mesh.device, iters=10)))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mesh", default=None, help="TxSxQ for collective sweep")
    p.add_argument("--cpu", action="store_true",
                   help="force CPU (a gloo world for --mesh)")
    p.add_argument("--max_pow", type=int, default=17)
    p.add_argument("--device", default=None,
                   help="device to run on (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.tools import _mesh

    device = entry_device("cpu" if args.cpu else args.device)
    names = ([f"cuda:{i} {torch.cuda.get_device_name(i)}"
              for i in range(torch.cuda.device_count())]
             if device.type == "cuda" else [str(device)])
    print(f"devices: {names}")

    # (a) device-memory gather sweep — the one-sided-read analog
    for m, dt in gather_sweep(device, args.max_pow):
        print(f"gather  {m:>8d} x4B: {dt*1e6:10.1f} us  "
              f"{m*4/dt/1e9:8.2f} GB/s")

    # (b) collective sweep over a mesh
    if args.mesh:
        t, s, q = _mesh.parse(args.mesh)
        rows = _mesh.run(all_gather_sweep, (t, s, q), device, args.max_pow)
        for m, dt in rows or ():
            print(f"all_gather {m:>8d} x4B x{t*s}dev: {dt*1e6:10.1f} us")


if __name__ == "__main__":
    main()
