"""Drive the PyTorch port's search paths once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. torch / CUDA versions, the card's name and power limit, CUDA_HOME;
  2. build the kernels from verticut_tpu_torch/csrc, one nvcc per source,
     all started together;
  3. each kernel == its plain twin, with both times, at the shapes the
     paths give it: blockmin at Q = 8192 queries, N = 1M codes, blocks 512
     and 128, on the corpus as it is and padded to a multiple of
     128 * block as the reference's row-major kernel takes it; pairwise at
     Q = 8192, N = 131072;
  4. the main path as bench.py drives it: 1M clustered 128-bit codes,
     m = 4 tables, 8192 perturbed queries at k = 10 and k = 100, then 8192
     uniform queries at k = 10; each cell checked against the popcount
     oracle (256 queries) and against its own ids' true distances;
  5. linear_search at 1M, 8192 uniform queries, k = 10 and 100, under the
     pallas, matmul and blockmin methods: equal to each other on every row
     and to the popcount oracle on 256, one cold and one warm time each;
  6. the loop driver (fused=False) on the 1M k = 10 cell, equal to the
     fused driver on every row and to the oracle on 256, and on 256
     uniform queries, which all take its linear fallback;
  7. approximate mode at k = 10 (a k * 20 pool), fused and loop driver:
     equal on every row both stop at one radius (the rest took the fused
     driver's exact scan tier and equal the oracle), every id at its
     returned distance; recall against the exact oracle printed;
  8. scale: the blockmin check and the k = 10 cell at 10M codes (64-query
     oracle).
Phases 4 to 7 each set the kernels' launch counts to 0 before they run
and read them after. The line before the last is a JSON record of the
kernels; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

Q = 8192
N_MAIN = 1_000_000
N_SCALE = 10_000_000
N_PAIRWISE = 131_072


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


def kernel_vs_twin(torch, name, kernel, twin, args):
    """Exact comparison of ``kernel(*args)`` and ``twin(*args)``; returns
    (max_abs_err, kernel ms averaged over 10 launches after a warm-up,
    twin ms of one call)."""
    got = kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = twin(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(got.shape == want.shape,
          f"{name}: kernel shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got - want).abs().max()) if got.numel() else 0
    check(err == 0, f"{name}: kernel != twin, max abs err {err}")
    del got, want
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(10):
        kernel(*args)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 10
    log(f"{name}: kernel == twin (max abs err {err}); kernel {ms:.3f} ms, "
        f"twin {plain_ms:.1f} ms")
    return err, ms, plain_ms


def blockmin_vs_twin(torch, kb, queries, db, block, n=None):
    n = db.shape[0] if n is None else n
    return kernel_vs_twin(
        torch, f"blockmin Q={queries.shape[0]} N={n} rows={db.shape[0]} "
        f"block={block}", kb.blockmin, kb.blockmin_reference,
        (queries, db, n, block))


def padded(torch, db, unit):
    """``db`` with zero rows appended up to a multiple of ``unit``."""
    out = torch.zeros((-(-db.shape[0] // unit) * unit, db.shape[1]),
                      dtype=db.dtype, device=db.device)
    out[:db.shape[0]] = db
    return out


def check_result(torch, name, res, codes_t, q, k):
    """Shape, a full top-k, ascending dists, and every id's true distance
    equal to its returned distance."""
    from verticut_tpu_torch import codes
    check(res.dists.shape == (len(q), k) and res.ids.shape == (len(q), k),
          f"{name}: result shape {tuple(res.dists.shape)}")
    check(bool((res.ids >= 0).all()), f"{name}: fewer than k results")
    true_d = codes.hamming_distance(codes_t[res.ids.long()], q[:, None, :])
    check(torch.equal(true_d, res.dists), f"{name}: ids disagree with dists")
    check(bool((res.dists[:, 1:] >= res.dists[:, :-1]).all()),
          f"{name}: dists not ascending")


def timed(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_cell(torch, name, index, queries, scfg, n_oracle, kb):
    """Warm-up batch, then three timed batches; then the oracle and the
    id/distance cross-check. Returns the kernel launches of the batches."""
    from verticut_tpu_torch import bits
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
    check_result(torch, name, res, index.codes, q, k)
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


def linear_phase(torch, kb, kp, db, u_dev):
    """Phase 5: the linear_search methods against each other and the
    oracle. Returns the kernels' launches in the phase."""
    from verticut_tpu_torch.ops.hamming import scan_popcount
    from verticut_tpu_torch.search import linear_search
    kb.launches = kp.launches = 0
    for k in (10, 100):
        od, oi = scan_popcount(u_dev[:256], db, k)
        first = None
        for method in ("pallas", "matmul", "blockmin"):
            (d, i), cold = timed(torch, lambda: linear_search(
                u_dev, db, k, method=method))
            (d, i), warm = timed(torch, lambda: linear_search(
                u_dev, db, k, method=method))
            check(d.shape == (len(u_dev), k), f"linear {method} k={k}: shape")
            check(torch.equal(d[:256], od) and torch.equal(i[:256], oi),
                  f"linear {method} k={k}: oracle")
            if first is None:
                first = (method, d, i)
            else:
                check(torch.equal(d, first[1]) and torch.equal(i, first[2]),
                      f"linear {method} k={k} != {first[0]} on some row")
            log(f"linear_search N={db.shape[0]} Q={len(u_dev)} k={k} "
                f"method={method}: cold {cold:.4f} s, warm {warm:.4f} s; "
                f"equal to {first[0]} on every row, oracle (256) equal")
    launches = {"blockmin": kb.launches, "pairwise": kp.launches}
    log(f"linear phase launches: {launches}")
    check(launches["pairwise"] > 0, "method=pallas launched no pairwise "
          "kernel")
    check(launches["blockmin"] > 0, "method=blockmin launched no blockmin "
          "kernel")
    return launches


def loop_phase(torch, kb, index, q_dev, u_dev, scfg):
    """Phase 6: the loop driver against the fused driver and the oracle.
    Returns the blockmin launches in the phase."""
    import dataclasses
    from verticut_tpu_torch.ops.hamming import scan_popcount
    from verticut_tpu_torch.search import mih_search
    fused = mih_search(index, q_dev, scfg)
    loop_cfg = dataclasses.replace(scfg, fused=False)
    kb.launches = 0
    res, first = timed(torch, lambda: mih_search(index, q_dev, loop_cfg))
    res, warm = timed(torch, lambda: mih_search(index, q_dev, loop_cfg))
    check_result(torch, "loop 1M k=10", res, index.codes, q_dev, scfg.knn)
    check(torch.equal(res.dists, fused.dists)
          and torch.equal(res.ids, fused.ids),
          "loop driver != fused driver on some row")
    od, oi = scan_popcount(q_dev[:256], index.codes, scfg.knn)
    check(torch.equal(res.dists[:256], od) and torch.equal(res.ids[:256], oi),
          "loop driver != oracle")
    hist = torch.bincount(res.radius).tolist()
    log(f"loop 1M k=10: first batch {first:.4f} s, warm batch {warm:.4f} s; "
        f"radius histogram {hist}; equal to the fused driver on all "
        f"{len(q_dev)} rows, oracle (256) equal")
    uq = u_dev[:256]
    ures, us = timed(torch, lambda: mih_search(index, uq, loop_cfg))
    od, oi = scan_popcount(uq, index.codes, scfg.knn)
    check(torch.equal(ures.dists, od) and torch.equal(ures.ids, oi),
          "loop driver, uniform queries != oracle")
    log(f"loop 1M uniform k=10, 256 queries: {us:.4f} s, oracle equal")
    log(f"loop phase launches: blockmin {kb.launches}")
    check(kb.launches > 0, "the loop driver's fallback launched no blockmin "
          "kernel")
    return kb.launches


def approx_phase(torch, kb, index, q_dev, scfg):
    """Phase 7: approximate mode, fused and loop driver. A row that both
    drivers stop at the same radius went through the same steps and must
    be bit-equal. The fused driver's later stages take at most
    ``nq >> 5`` rows, and the rows past that budget take its exact scan
    tier with the radius they had: those rows must equal the exact
    oracle."""
    import dataclasses
    from verticut_tpu_torch.ops.hamming import scan_popcount
    from verticut_tpu_torch.search import mih_search
    acfg = dataclasses.replace(scfg, approximate=True)
    kb.launches = 0
    out = {}
    for fused in (True, False):
        c = dataclasses.replace(acfg, fused=fused)
        mih_search(index, q_dev, c)
        out[fused], warm = timed(torch, lambda: mih_search(index, q_dev, c))
        check_result(torch, f"approx fused={fused}", out[fused], index.codes,
                     q_dev, scfg.knn)
        log(f"approx 1M k=10 (pool {acfg.pool_size}) fused={fused}: warm "
            f"batch {warm:.4f} s, radius histogram "
            f"{torch.bincount(out[fused].radius).tolist()}")
    a, b = out[True], out[False]
    same_r = a.radius == b.radius
    equal = (a.dists == b.dists).all(-1) & (a.ids == b.ids).all(-1)
    check(bool(equal[same_r].all()),
          "approximate: fused != loop on a row both stop at one radius")
    spilled = torch.nonzero(~same_r).flatten()[:256]
    sd, si = scan_popcount(q_dev[spilled], index.codes, scfg.knn)
    check(torch.equal(a.dists[spilled], sd) and torch.equal(a.ids[spilled], si),
          "approximate: a row of the fused scan tier != the exact oracle")
    od, oi = scan_popcount(q_dev[:256], index.codes, scfg.knn)
    recall = {f: float((r.ids[:256, :, None] == oi[:, None, :]).any(-1)
                       .float().mean()) for f, r in out.items()}
    log(f"approx: fused == loop on {int(equal.sum())} of {len(q_dev)} rows, "
        f"on all {int(same_r.sum())} rows with one radius; "
        f"{int((~same_r).sum())} rows took the fused scan tier (oracle-"
        f"equal on {len(spilled)} checked); recall@{scfg.knn} by id against "
        f"the exact oracle (256 queries): fused {recall[True]:.4f}, loop "
        f"{recall[False]:.4f}; blockmin launches {kb.launches}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from verticut_tpu_torch import bits, codes
    from verticut_tpu_torch.config import MIHConfig, SearchConfig
    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.kernels import _build
    from verticut_tpu_torch.kernels import blockmin as kb
    from verticut_tpu_torch.kernels import pairwise as kp

    # 1. environment
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} CUDA_HOME={os.environ.get('CUDA_HOME')}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    dev = torch.device("cuda", 0)

    # 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len((kb, kp))) as pool:
        for f in [pool.submit(m.build) for m in (kb, kp)]:
            f.result()
    log(f"kernels built for sm_90a in {time.perf_counter() - t0:.2f} s")
    for m in (kb, kp):
        log(f"  {os.path.relpath(m.SOURCE)}")
        for line in _build.build_logs.get(m.NAME, "").splitlines():
            if "registers" in line:
                log("    " + line.strip())

    # 3. kernels vs twins at the paths' shapes
    packed = codes.clustered_codes(0, N_MAIN, 128, n_clusters=N_MAIN // 200,
                                   flip_p=0.02)
    queries = bench_queries(packed, Q)
    db = bits.as_codes(packed, dev)
    q_dev = bits.as_codes(queries, dev)
    u_dev = bits.as_codes(codes.random_codes(99, Q, 128), dev)
    cmp = {b: blockmin_vs_twin(torch, kb, u_dev, db, b) for b in (512, 128)}
    max_err = {"blockmin": max(c[0] for c in cmp.values())}
    for b in (512, 128):      # K3's operand: rows past n are pad
        err = blockmin_vs_twin(torch, kb, u_dev, padded(torch, db, 128 * b),
                               b, n=N_MAIN)[0]
        max_err["blockmin"] = max(max_err["blockmin"], err)
    pw = kernel_vs_twin(torch, f"pairwise Q={Q} N={N_PAIRWISE}", kp.pairwise,
                        kp.pairwise_reference, (u_dev, db[:N_PAIRWISE]))
    max_err["pairwise"] = pw[0]
    torch.cuda.empty_cache()

    # 4. the main path, counted
    cfg = MIHConfig(bits=128, n_tables=4)
    k10 = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    k100 = SearchConfig(knn=100, candidate_cap=8192, max_enum_radius=5)
    kb.launches = kp.launches = 0
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

    # 5.-7. the linear-scan methods, the loop driver, approximate mode
    linear = linear_phase(torch, kb, kp, index.codes, u_dev)
    loop_phase(torch, kb, index, q_dev, u_dev, k10)
    approx_phase(torch, kb, index, q_dev, k10)
    del index, q_dev, u_dev, db
    torch.cuda.empty_cache()

    # 8. scale
    t0 = time.perf_counter()
    big = codes.clustered_codes(0, N_SCALE, 128, n_clusters=N_SCALE // 200,
                                flip_p=0.02)
    log(f"generated N={N_SCALE} on the host in {time.perf_counter() - t0:.1f} s")
    bq = bits.as_codes(bench_queries(big, Q), dev)
    bu = bits.as_codes(codes.random_codes(99, Q, 128), dev)
    db = bits.as_codes(big, dev)
    for b in (512, 128):
        max_err["blockmin"] = max(max_err["blockmin"],
                                  blockmin_vs_twin(torch, kb, bu, db, b)[0])
    del db, bu
    t0 = time.perf_counter()
    index = build_index(big, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"build N={N_SCALE}: {time.perf_counter() - t0:.3f} s, pbits "
        f"{index.tables[0].directory.pbits}")
    run_cell(torch, "10M k=10", index, bq, k10, 64, kb)

    src = "verticut_tpu/ops/pallas/linear_scan.py"
    print(json.dumps({"kernels": [
        {"name": "blockmin", "route": "cuda",
         "source": "verticut_tpu_torch/csrc/blockmin.cu",
         "replaces": f"{src}:106,295,346",
         "launches": main_launches, "max_abs_err": max_err["blockmin"],
         "ms": cmp[512][1], "plain_ms": cmp[512][2],
         "shape": f"Q={Q} N={N_MAIN} block=512"},
        {"name": "pairwise", "route": "cuda",
         "source": "verticut_tpu_torch/csrc/pairwise.cu",
         "replaces": f"{src}:419",
         "launches": linear["pairwise"], "max_abs_err": max_err["pairwise"],
         "ms": pw[1], "plain_ms": pw[2],
         "shape": f"Q={Q} N={N_PAIRWISE}"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
