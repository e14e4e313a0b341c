"""Where a batch's time goes: one warm batch of a benchmark cell under
``torch.profiler``.

Run on a machine with an NVIDIA GPU:

    python -m verticut_tpu_torch.breakdown [N ...]

For each corpus size N (by default 1,000,000 and 100,000,000) it builds the
benchmark's index (:func:`verticut_tpu_torch.bench.make_index`) and
profiles one warm 8192-query batch of the uniform cell
(``random_codes(99, 8192)``) and of the k = 10 cell (corpus rows with 3
bit flips), both at k = 10. It prints one JSON line per cell:

* ``wall_s``: the median of three unprofiled warm batches (``mih_search``
  ending in a device sync);
* ``device_s``: the union of the card's kernel intervals in the profiled
  batch, and ``idle`` = 1 - device_s / wall_s;
* ``kernels``: kernels launched, and ``launch_cpu_s``, the host time of
  ``cudaLaunchKernel``;
* ``top``: the kernels by device time (name up to its argument list,
  seconds, launches), and ``blockmin``, the batch's blockmin launches by
  instance.

It exits non-zero without CUDA. :func:`profile_cell` takes any device; on
the CPU the profile has no device intervals and ``device_s`` is None.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import bench, codes
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.search import mih_search

Q = 8192
TOP = 10


def _short(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:100]


def _union(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_cell(index, queries, scfg: SearchConfig) -> dict:
    """One warm batch of ``mih_search(index, queries, scfg)`` under the
    profiler, beside three unprofiled ones (see the module docstring)."""
    dev = index.device
    mih_search(index, queries, scfg)                 # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        mih_search(index, queries, scfg)
        bench.sync(dev)
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = dict(kb.launches_by_instance)
    with torch.profiler.profile(activities=acts) as prof:
        mih_search(index, queries, scfg)
        bench.sync(dev)
    blockmin = {k: v - before[k] for k, v in kb.launches_by_instance.items()}
    kernels, by_name, launch_us = [], {}, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.end))
            t, c = by_name.get(_short(e.name), (0.0, 0))
            by_name[_short(e.name)] = (t + e.time_range.elapsed_us(), c + 1)
        elif e.name == "cudaLaunchKernel":
            launch_us += e.time_range.elapsed_us()
    wall = statistics.median(walls)
    device = _union(kernels) * 1e-6 if kernels else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"wall_s": wall, "walls_s": walls, "device_s": device,
            "idle": None if device is None else 1 - device / wall,
            "kernels": len(kernels), "launch_cpu_s": launch_us * 1e-6,
            "top": [[n, t * 1e-6, c] for n, (t, c) in top],
            "blockmin": blockmin}


def run(n: int, device) -> list:
    """The uniform and k = 10 cells at corpus size ``n`` on ``device``."""
    index, info = bench.make_index(n, device)
    scfg = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    cells = (("uniform k=10", bits_lib.as_codes(
                 codes.random_codes(99, Q, bench.CFG.bits), device)),
             ("k=10", bench.perturbed_queries(np.random.default_rng(0),
                                              index.codes, Q)))
    out = []
    for name, q in cells:
        rec = {"n": n, "cell": name, **profile_cell(index, q, scfg)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    del index
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        bench.log("breakdown: torch.cuda.is_available() is False; the profile "
                  "measures a CUDA card")
        return 2
    bench.log(json.dumps(bench.card()))
    for n in [int(a) for a in argv] or [1_000_000, 100_000_000]:
        run(n, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
