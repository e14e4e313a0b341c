"""The block-min scan on its two blockmin instances: the port's twin of
``tools/int8_scan_bench.py``.

The JAX tool asks whether the TPU kernel gains from int8 operands over
bf16 at the 100M uniform cell's shapes. On the H100 the same question is
the tensor-core instance (an int8 ``wgmma`` +-1 GEMM) against the generic
one (XOR and popcount on the CUDA cores): ``scan_blockmin`` over N
clustered codes made on the device, Q corpus rows as queries
(``default_rng(1)``), k = 10, at blocks 128 and 512, each instance's mean
of 3 batches after a warm-up (queries alternately XORed with 1, as the JAX
tool does). Then, at block 128, the two instances' answers must be equal
in dists and ids, or the tool exits 1.

It prints the JAX tool's lines with ``instance=`` for ``acc=``, then one
JSON line.

Usage: python -m verticut_tpu_torch.tools.int8_scan_bench [N] [--q 8192]
[--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from verticut_tpu_torch import bench, codes
from verticut_tpu_torch.bits import entry_device
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.ops import hamming

K = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", type=int, nargs="?", default=16_000_000)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    n, q = args.n, args.q
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}  n={n} q={q}", flush=True)
    db = codes.clustered_codes_device(0, n, 128, n_clusters=max(1, n // 200),
                                      flip_p=0.02, device=dev)
    rng = np.random.default_rng(1)
    queries = db[torch.from_numpy(rng.integers(0, n, q)).to(dev)]
    ms = {}
    for block in (128, 512):
        for which in kb.INSTANCES:
            d, _ = hamming.scan_blockmin(queries, db, K, block=block,
                                         which=which)       # warm-up
            bench.sync(dev)
            reps = 3
            t0 = time.time()
            for r in range(reps):
                d, _ = hamming.scan_blockmin(queries ^ (r % 2), db, K,
                                             block=block, which=which)
                bench.sync(dev)
            dt = (time.time() - t0) / reps
            ms[f"block{block}_{which}"] = dt * 1e3
            print(f"block={block:4d} instance={which}: {dt * 1e3:8.1f} "
                  f"ms/batch ({q / dt:8.0f} QPS)", flush=True)
    dt_, it_ = hamming.scan_blockmin(queries, db, K, block=128,
                                     which="tensor")
    dg, ig = hamming.scan_blockmin(queries, db, K, block=128,
                                   which="generic")
    same_d, same_i = bool(torch.equal(dt_, dg)), bool(torch.equal(it_, ig))
    print(f"tensor vs generic: distances_equal={same_d} ids_equal={same_i}",
          flush=True)
    rec = {"metric": "int8_scan_bench", "n": n, "q": q, "k": K, "ms": ms,
           "distances_equal": same_d, "ids_equal": same_i, "device": name}
    print(json.dumps(rec), flush=True)
    if not (same_d and same_i):
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
