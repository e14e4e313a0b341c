"""Drive the PyTorch port's exact MIH search once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. torch / CUDA versions, the card's name and power limit, CUDA_HOME;
  2. build the blockmin kernel from verticut_tpu_torch/csrc with nvcc;
  3. blockmin kernel == plain twin at Q = 8192 queries, N = 1M codes,
     blocks 512 and 128, with both times;
  4. the main path as bench.py drives it: 1M clustered 128-bit codes,
     m = 4 tables, 8192 perturbed queries at k = 10 and k = 100, then 8192
     uniform queries at k = 10; each cell checked against the popcount
     oracle (256 queries) and against its own ids' true distances;
  5. scale: the kernel check and the k = 10 cell at 10M codes (64-query
     oracle).
The line before the last is a JSON record of the kernels of the path; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

Q = 8192
N_MAIN = 1_000_000
N_SCALE = 10_000_000


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bench_queries(packed, n_queries, seed=0):
    """bench.py's queries: random corpus rows with 3 random bit flips."""
    from verticut_tpu_torch import codes
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, len(packed), n_queries)
    qraw = codes.unpack_to_bytes(packed[sel])
    flips = rng.integers(0, 128, (n_queries, 3))
    for i in range(n_queries):
        for b in flips[i]:
            qraw[i, b // 8] ^= 1 << (b % 8)
    return codes.pack_bytes(qraw)


def kernel_vs_twin(torch, kb, queries, db, block):
    """Exact comparison of kernel and twin; returns (max_abs_err, kernel ms
    averaged over 10 launches after a warm-up, twin ms of one call)."""
    n = db.shape[0]
    got = kb.blockmin(queries, db, n, block)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = kb.blockmin_reference(queries, db, n, block)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(got.shape == want.shape and err == 0,
          f"kernel != twin at block {block}, N={n}: max abs err {err}")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(10):
        kb.blockmin(queries, db, n, block)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 10
    log(f"blockmin Q={queries.shape[0]} N={n} block={block}: kernel == twin "
        f"(max abs err {err}); kernel {ms:.3f} ms, twin {plain_ms:.1f} ms")
    return err, ms, plain_ms


def run_cell(torch, name, index, queries, scfg, n_oracle, kb):
    """Warm-up batch, then three timed batches; then the oracle and the
    id/distance cross-check. Returns the kernel launches of the batches."""
    from verticut_tpu_torch import bits, codes
    from verticut_tpu_torch.ops.hamming import scan_popcount
    from verticut_tpu_torch.search import mih_search
    q = bits.as_codes(queries, index.device)
    before = kb.launches
    t0 = time.perf_counter()
    res = mih_search(index, q, scfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = mih_search(index, q, scfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = kb.launches - before
    k = scfg.knn
    check(res.dists.shape == (len(q), k) and res.ids.shape == (len(q), k),
          f"{name}: result shape {tuple(res.dists.shape)}")
    check(bool((res.ids >= 0).all()), f"{name}: fewer than k results")
    true_d = codes.hamming_distance(index.codes[res.ids.long()],
                                    q[:, None, :])
    check(torch.equal(true_d, res.dists), f"{name}: ids disagree with dists")
    check(bool((res.dists[:, 1:] >= res.dists[:, :-1]).all()),
          f"{name}: dists not ascending")
    t0 = time.perf_counter()
    od, oi = scan_popcount(q[:n_oracle], index.codes, k)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    check(torch.equal(res.dists[:n_oracle], od), f"{name}: oracle dists")
    check(torch.equal(res.ids[:n_oracle], oi), f"{name}: oracle ids")
    hist = torch.bincount(res.radius).tolist()
    log(f"cell {name}: first batch {first_s:.4f} s, warm batch "
        f"{min(times):.4f} s (runs {', '.join(f'{t:.4f}' for t in times)}), "
        f"{len(q) / min(times):.0f} queries/s; radius histogram {hist}; "
        f"blockmin launches {launches}; oracle ({n_oracle} queries, "
        f"{oracle_s:.2f} s) dists and ids equal")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from verticut_tpu_torch import bits, codes
    from verticut_tpu_torch.config import MIHConfig, SearchConfig
    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.kernels import blockmin as kb

    # 1. environment
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} CUDA_HOME={os.environ.get('CUDA_HOME')}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    kb.build()
    log(f"blockmin built for sm_90a from {os.path.relpath(kb.SOURCE)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in kb.build_log.splitlines():
        if "nvcc" in line or "registers" in line:
            log("  " + line.strip())

    # 3. kernel vs twin at the main path's shapes
    packed = codes.clustered_codes(0, N_MAIN, 128, n_clusters=N_MAIN // 200,
                                   flip_p=0.02)
    queries = bench_queries(packed, Q)
    db = bits.as_codes(packed, dev)
    q_dev = bits.as_codes(queries, dev)
    u_dev = bits.as_codes(codes.random_codes(99, Q, 128), dev)
    cmp = {b: kernel_vs_twin(torch, kb, u_dev, db, b) for b in (512, 128)}
    max_err = max(c[0] for c in cmp.values())
    del db

    # 4. the main path, counted
    cfg = MIHConfig(bits=128, n_tables=4)
    k10 = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    k100 = SearchConfig(knn=100, candidate_cap=8192, max_enum_radius=5)
    kb.launches = 0
    t0 = time.perf_counter()
    index = build_index(packed, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"build N={N_MAIN}: {time.perf_counter() - t0:.3f} s, pbits "
        f"{index.tables[0].directory.pbits}")
    run_cell(torch, "1M k=10", index, q_dev, k10, 256, kb)
    run_cell(torch, "1M k=100", index, q_dev, k100, 256, kb)
    uniform = run_cell(torch, "1M uniform k=10", index, u_dev, k10, 256, kb)
    main_launches = kb.launches
    check(uniform > 0, "the uniform cell launched no blockmin kernel")
    check(main_launches > 0, "the main path launched no blockmin kernel")
    del index, q_dev, u_dev

    # 5. scale
    t0 = time.perf_counter()
    big = codes.clustered_codes(0, N_SCALE, 128, n_clusters=N_SCALE // 200,
                                flip_p=0.02)
    log(f"generated N={N_SCALE} on the host in {time.perf_counter() - t0:.1f} s")
    bq = bits.as_codes(bench_queries(big, Q), dev)
    bu = bits.as_codes(codes.random_codes(99, Q, 128), dev)
    db = bits.as_codes(big, dev)
    for b in (512, 128):
        max_err = max(max_err, kernel_vs_twin(torch, kb, bu, db, b)[0])
    del db, bu
    t0 = time.perf_counter()
    index = build_index(big, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"build N={N_SCALE}: {time.perf_counter() - t0:.3f} s, pbits "
        f"{index.tables[0].directory.pbits}")
    run_cell(torch, "10M k=10", index, bq, k10, 64, kb)

    print(json.dumps({"kernels": [{
        "name": "blockmin", "route": "cuda",
        "source": "verticut_tpu_torch/csrc/blockmin.cu",
        "replaces": "verticut_tpu/ops/pallas/linear_scan.py:295,346",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": cmp[512][1], "plain_ms": cmp[512][2],
        "shape": f"Q={Q} N={N_MAIN} block=512"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
