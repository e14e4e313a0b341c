"""Drive the PyTorch port's search paths once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. torch / CUDA versions, the card's name and power limit, CUDA_HOME;
  2. build the kernels from verticut_tpu_torch/csrc, one nvcc per source,
     all started together, and print ptxas's registers, spills and wgmma
     serialisation warnings;
  3. each kernel == its plain twin, with both times, at the shapes the
     paths give it: blockmin's tensor-core instance at Q = 8192 and at
     Q = 128 (the straggler tier), N = 1M codes, blocks 512 and 128, on the
     corpus as it is and padded to a multiple of 128 * block as the
     reference's row-major kernel takes it, each time beside its int8
     tensor-core bound and share, and at Q = 687 and 768 (a 100M query
     slice and its padded tile); pairwise at Q = 8192, N = 131072, beside
     its store bound and one torch.cdist call; blockmin at blocks 16 and
     1000 (the generic instance) and 1024 and 2048, and both kernels at
     64- and 256-bit codes (blockmin's tensor-core instance at W = 2 and
     W = 8), and every template instance of the tensor-core kernel (W = 1
     to 8 at blocks 32, 64 and 1024) on a ragged corpus at Q = 129;
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
  8. dispatch / finalize at 1M: two handles in flight, finalized out of
     order, equal to mih_search on every row;
  9. a 64-bit index (MIHConfig(bits=64, n_tables=2), 1M codes) under 8192
     uniform queries: all scan tier (the tensor-core instance at W = 2),
     oracle-equal on 256;
 10. the oracle drive at 1M, k = 500 and 1000 (verticut_tpu_torch.
     oracle_drive);
 11. scale: the reference's default corpus, 100M codes generated on the
     card, built without the flat id columns; 8192 perturbed queries at
     k = 10 and k = 100 and 8192 uniform queries at k = 10 through the
     depth-4 dispatch / finalize pipeline, each checked against the
     popcount oracle on 64 queries (dists and ids) and on every returned
     id's true distance; the radius steps must take the wide-id (_pos)
     selections and the result row the [Q, 2k + 3] layout, and every
     blockmin launch the whole batch of its scan (the folded selection:
     full-batch corpus chunks, not query slices);
 12. the bucket directories at 1M codes, 8192 perturbed queries, k = 10:
     MIHConfig(bits=128, n_tables=8) with default arguments (auto picks
     the dense directory at 16-bit substrings), without and with the
     bitmap, and n_tables=4 with the sorted, prefix and hash directories,
     each through the fused and the loop driver: every id at its returned
     distance, and dists and ids equal to the popcount oracle on 256
     queries and to the range engine on every row, but for the ids among
     the codes at a row's kth distance (the stop rule of the reference
     may stop before it has seen them all; the count is printed);
 13. 1B codes on one card: bench.make_index(1e9) (generated on the card,
     compact layout, no flat id columns; generation and build seconds,
     peak device memory), 8192 perturbed and 8192 uniform queries at
     k = 10 through bench.cell, each equal to the popcount oracle on 32
     queries (dists and ids), the radius steps on the _pos merges, every
     blockmin launch on the tensor-core instance with the whole batch of
     its scan.
Phases 4 to 13 each set the kernels' launch counts (blockmin's also by
instance) to 0 before they run and read them after; the main path's
(phases 4, 11, 12 and 13) must go through the tensor-core instance. The
line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

Q = 8192
N_MAIN = 1_000_000
N_SCALE = 100_000_000
N_PAIRWISE = 131_072
N_SCALE_ORACLE = 64
N_BILLION = 1_000_000_000
N_BILLION_ORACLE = 32
#: an H100 SXM's dense int8 tensor-core rate (ops/s) and memory rate (B/s)
H100_INT8_OPS = 1979e12
H100_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def zero_counts(kb, kp):
    kb.launches = kp.launches = 0
    kb.launches_by_instance.update(dict.fromkeys(kb.INSTANCES, 0))


def blockmin_bound(nq, n, n_rows, w, block):
    """The least time of a blockmin call over ``n`` valid rows of
    ``n_rows``, ms: its 2 * Q * n * 32W int8 tensor-core operations or its
    bytes (the queries and valid rows read once, the output written once),
    whichever takes longer; and which it is."""
    ops = 2 * nq * n * 32 * w / H100_INT8_OPS * 1e3
    nbytes = 4 * (nq * w + n * w + nq * -(-n_rows // block))
    by_bytes = nbytes / H100_BYTES * 1e3
    return (ops, "operations") if ops >= by_bytes else (by_bytes, "bytes")


def kernel_vs_twin(torch, name, kernel, twin, args, bound=None):
    """Exact comparison of ``kernel(*args)`` and ``twin(*args)``; returns
    (max_abs_err, kernel ms averaged over 10 launches after a warm-up,
    twin ms of one call). ``bound``: the least time in ms, printed with
    the kernel's share of it."""
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
    kernel(*args)
    e0.record()
    for _ in range(10):
        kernel(*args)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 10
    share = f", bound {bound:.4f} ms, share {bound / ms:.1%}" if bound else ""
    log(f"{name}: kernel == twin (max abs err {err}); kernel {ms:.4f} ms"
        f"{share}, twin {plain_ms:.1f} ms")
    return err, ms, plain_ms


def blockmin_vs_twin(torch, kb, queries, db, block, n=None):
    n = db.shape[0] if n is None else n
    nq, w = queries.shape
    return kernel_vs_twin(
        torch, f"blockmin ({kb.instance(w, block)}) Q={nq} N={n} "
        f"rows={db.shape[0]} W={w} block={block}", kb.blockmin,
        kb.blockmin_reference, (queries, db, n, block),
        bound=blockmin_bound(nq, n, db.shape[0], w, block)[0])


def padded(torch, db, unit):
    """``db`` with zero rows appended up to a multiple of ``unit``."""
    out = torch.zeros((-(-db.shape[0] // unit) * unit, db.shape[1]),
                      dtype=db.dtype, device=db.device)
    out[:db.shape[0]] = db
    return out


def check_result(torch, name, res, db, q, k):
    """Shape, a full top-k, ascending dists, and every id's true distance
    equal to its returned distance (``res`` on the host, ``db`` and ``q``
    on the card)."""
    from verticut_tpu_torch import codes
    check(res.dists.shape == (len(q), k) and res.ids.shape == (len(q), k),
          f"{name}: result shape {tuple(res.dists.shape)}")
    check(bool((res.ids >= 0).all()), f"{name}: fewer than k results")
    true_d = codes.hamming_distance(db[res.ids.to(db.device).long()],
                                    q[:, None, :])
    check(torch.equal(true_d.cpu(), res.dists),
          f"{name}: ids disagree with dists")
    check(bool((res.dists[:, 1:] >= res.dists[:, :-1]).all()),
          f"{name}: dists not ascending")


def tie_equal(torch, name, res, dists, ids):
    """``res`` against another exact answer ``(dists, ids)`` (host
    tensors): dists equal on every row, ids equal except among the codes
    at a row's kth distance, where two exact answers may keep different
    ones. The bucket engines' stop rule, the reference's (kth distance at
    most (radius + 1) * m), can stop before every code at that distance
    was seen. Returns how many rows kept other ids at the kth distance."""
    check(torch.equal(res.dists, dists), f"{name}: dists differ")
    same = res.ids == ids
    check(bool((same | (res.dists == res.dists[:, -1:])).all()),
          f"{name}: ids differ below the kth distance")
    return int((~same.all(-1)).sum())


def oracle(q, db, k, chunk=65536):
    """The popcount oracle's (dists, ids), on the host."""
    from verticut_tpu_torch.ops.hamming import scan_popcount
    od, oi = scan_popcount(q, db, k, chunk=chunk)
    return od.cpu(), oi.cpu()


@contextlib.contextmanager
def patched(*swaps):
    """Set each ``(object, attribute, value)`` for the block's duration."""
    old = [(o, a, getattr(o, a)) for o, a, _ in swaps]
    for o, a, v in swaps:
        setattr(o, a, v)
    try:
        yield
    finally:
        for o, a, v in old:
            setattr(o, a, v)


@contextlib.contextmanager
def whole_batch_scans(kb):
    """Record every block-min scan (``scan_blockmin`` as the drivers and
    linear_search call it) and every blockmin call inside one. Yields a
    dict: ``scans``, the query counts of the scans; ``split``, the calls
    whose query count was not their scan's whole batch. The kernel's own
    launch counts stay the wrapper's."""
    from verticut_tpu_torch.ops import hamming
    from verticut_tpu_torch.search import single
    rec = {"scans": [], "split": 0}
    scan, launch, cur = hamming.scan_blockmin, kb.blockmin, []

    def scan_rec(queries, *a, **kw):
        rec["scans"].append(queries.shape[0])
        cur.append(queries.shape[0])
        try:
            return scan(queries, *a, **kw)
        finally:
            cur.pop()

    def launch_rec(queries, *a, **kw):
        rec["split"] += not cur or queries.shape[0] != cur[-1]
        return launch(queries, *a, **kw)

    with patched((hamming, "scan_blockmin", scan_rec),
                 (single, "scan_blockmin", scan_rec),
                 (kb, "blockmin", launch_rec)):
        yield rec


@contextlib.contextmanager
def counted_merges():
    """Count the radius steps' strip merges by branch: ``pos`` (wide ids)
    and ``packed``."""
    from verticut_tpu_torch.ops import topk
    merges = {"pos": 0, "packed": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            merges[name] += 1
            return fn(*a, **kw)
        return wrapper

    with patched((topk, "merge_strips_dedup_pos",
                  counted("pos", topk.merge_strips_dedup_pos)),
                 (topk, "merge_strips_packed",
                  counted("packed", topk.merge_strips_packed))):
        yield merges


def timed(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_cell(torch, name, index, q, scfg, n_oracle, kb):
    """Warm-up batch, then three timed batches; then the oracle and the
    id/distance cross-check. Returns the blockmin launches of the batches
    and the last result."""
    from verticut_tpu_torch.bench import latency
    before = kb.launches
    first_s, times, res = latency(index, q, scfg)
    launches = kb.launches - before
    k = scfg.knn
    check_result(torch, name, res, index.codes, q, k)
    t0 = time.perf_counter()
    od, oi = oracle(q[:n_oracle], index.codes, k)
    oracle_s = time.perf_counter() - t0
    check(torch.equal(res.dists[:n_oracle], od), f"{name}: oracle dists")
    check(torch.equal(res.ids[:n_oracle], oi), f"{name}: oracle ids")
    hist = torch.bincount(res.radius).tolist()
    log(f"cell {name}: first batch {first_s:.4f} s, warm batch "
        f"{min(times):.4f} s (runs {', '.join(f'{t:.4f}' for t in times)}), "
        f"{len(q) / min(times):.0f} queries/s; radius histogram {hist}; "
        f"blockmin launches {launches}; oracle ({n_oracle} queries, "
        f"{oracle_s:.2f} s) dists and ids equal")
    return launches, res


def linear_phase(torch, kb, kp, db, u_dev):
    """Phase 5: the linear_search methods against each other and the
    oracle. Returns the kernels' launches in the phase."""
    from verticut_tpu_torch.search import linear_search
    kb.launches = kp.launches = 0
    for k in (10, 100):
        od, oi = oracle(u_dev[:256], db, k)
        first = None
        for method in ("pallas", "matmul", "blockmin"):
            (d, i), cold = timed(torch, lambda: linear_search(
                u_dev, db, k, method=method))
            (d, i), warm = timed(torch, lambda: linear_search(
                u_dev, db, k, method=method))
            check(d.shape == (len(u_dev), k), f"linear {method} k={k}: shape")
            check(torch.equal(d[:256].cpu(), od)
                  and torch.equal(i[:256].cpu(), oi),
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
    od, oi = oracle(q_dev[:256], index.codes, scfg.knn)
    check(torch.equal(res.dists[:256], od) and torch.equal(res.ids[:256], oi),
          "loop driver != oracle")
    hist = torch.bincount(res.radius).tolist()
    log(f"loop 1M k=10: first batch {first:.4f} s, warm batch {warm:.4f} s; "
        f"radius histogram {hist}; equal to the fused driver on all "
        f"{len(q_dev)} rows, oracle (256) equal")
    uq = u_dev[:256]
    ures, us = timed(torch, lambda: mih_search(index, uq, loop_cfg))
    od, oi = oracle(uq, index.codes, scfg.knn)
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
    sd, si = oracle(q_dev[spilled.to(q_dev.device)], index.codes, scfg.knn)
    check(torch.equal(a.dists[spilled], sd) and torch.equal(a.ids[spilled], si),
          "approximate: a row of the fused scan tier != the exact oracle")
    od, oi = oracle(q_dev[:256], index.codes, scfg.knn)
    recall = {f: float((r.ids[:256, :, None] == oi[:, None, :]).any(-1)
                       .float().mean()) for f, r in out.items()}
    log(f"approx: fused == loop on {int(equal.sum())} of {len(q_dev)} rows, "
        f"on all {int(same_r.sum())} rows with one radius; "
        f"{int((~same_r).sum())} rows took the fused scan tier (oracle-"
        f"equal on {len(spilled)} checked); recall@{scfg.knn} by id against "
        f"the exact oracle (256 queries): fused {recall[True]:.4f}, loop "
        f"{recall[False]:.4f}; blockmin launches {kb.launches}")


def generic_phase(torch, kb, kp, u_dev, db, dev):
    """Phase 3, second half: blockmin at blocks 16 and 1000 (the generic
    instance) and 1024 and 2048 (tensor cores) on the 1M corpus, and both
    kernels at 64- and 256-bit codes (blockmin's tensor-core instance at
    W = 2 and 8, pairwise's generic one). Returns the largest error, the
    generic blockmin's run at block 1000 (W = 4, beside the main path's
    block 512), pairwise's at 64-bit codes (beside the fast 128-bit one)
    and blockmin's at W = 2 (the 64-bit cell's shape), each ``(err, ms,
    plain_ms)``."""
    from verticut_tpu_torch import bits, codes
    blocks = {b: blockmin_vs_twin(torch, kb, u_dev, db, b)
              for b in (16, 1000, 1024, 2048)}
    check(kb.instance(4, 1000) == "generic"
          and kb.instance(4, 1024) == "tensor", "blockmin instance choice")
    err = max(c[0] for c in blocks.values())
    pw, bm = {}, {}
    for bits_w, n in ((64, N_MAIN), (256, 262_144)):
        q = bits.as_codes(codes.random_codes(6, Q, bits_w), dev)
        d = bits.as_codes(codes.random_codes(5, n, bits_w), dev)
        pw[bits_w] = kernel_vs_twin(
            torch, f"pairwise Q={Q} N={N_PAIRWISE} W={bits_w // 32}",
            kp.pairwise, kp.pairwise_reference, (q, d[:N_PAIRWISE]),
            bound=pairwise_bound(Q, N_PAIRWISE, bits_w // 32))
        bm[bits_w] = blockmin_vs_twin(torch, kb, q, d, 512)
        err = max(err, bm[bits_w][0], pw[bits_w][0])
        del q, d
    torch.cuda.empty_cache()
    return err, blocks[1000], pw[64], bm[64]


def instances_phase(torch, kb, dev):
    """Phase 3, last: every template instance of the tensor-core kernel
    (W = 1..8 by a block's share of a tile, 32, 64 or 128 rows) against
    the twin, exact, at Q = 129 on a corpus whose last block lies past n.
    Returns the largest error."""
    from verticut_tpu_torch import bits
    rng = np.random.default_rng(129)
    err = 0
    for w in range(1, 9):
        for block in (32, 64, 1024):
            check(kb.instance(w, block) == "tensor",
                  f"blockmin W={w} block={block}: not the tensor-core instance")
            n_rows = 2 * 2048 + 3 * block + 77
            n = n_rows - block - 40
            q = bits.as_codes(rng.integers(0, 1 << 32, (129, w),
                                           dtype=np.uint32), dev)
            db = bits.as_codes(rng.integers(0, 1 << 32, (n_rows, w),
                                            dtype=np.uint32), dev)
            db[n - 1] = q[0]
            got = kb.blockmin(q, db, n, block)
            want = kb.blockmin_reference(q, db, n, block)
            e = int((got - want).abs().max())
            check(e == 0, f"blockmin W={w} block={block} Q=129 N={n}: kernel "
                  f"!= twin, max abs err {e}")
            err = max(err, e)
    log("blockmin tensor cores, every instance (W = 1..8, blocks 32, 64, "
        "1024; Q=129, ragged n): kernel == twin (max abs err 0)")
    return err


def pairwise_bound(nq, n, w):
    """The least time of a pairwise call, ms: its int32 [Q, N] output
    written once and its inputs read once, at the memory rate."""
    return 4 * (nq * n + (nq + n) * w) / H100_BYTES * 1e3


def cdist_ms(torch, q, db, want):
    """One torch.cdist(p=0) call on 0/1 float bits (the library call for
    the pairwise function), ms over 3 calls after a warm-up; its counts
    must equal the kernel's ``want``."""
    from verticut_tpu_torch import codes
    a = (codes.unpack_bits_pm1(q) + 1) / 2
    b = (codes.unpack_bits_pm1(db) + 1) / 2
    got = torch.cdist(a, b, p=0)
    check(torch.equal(got.to(torch.int32), want), "cdist(p=0) != pairwise")
    del got
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        torch.cdist(a, b, p=0)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 3


def tensor_phase(torch, kb, u_dev, db):
    """Phase 3, first half: the tensor-core instance at the main path's
    shapes, against the twin, each time beside its bound: Q = 8192 and
    128, blocks 512 and 128, the corpus as it is and padded to 128 *
    block rows; then Q = 687 and 768 at block 512. Returns the largest
    error and ``{(Q, block, padded): (err, ms, plain_ms)}``."""
    runs = {}
    for nq in (Q, 128):
        q = u_dev[:nq].contiguous()
        for block in (512, 128):
            runs[nq, block, False] = blockmin_vs_twin(torch, kb, q, db, block)
            runs[nq, block, True] = blockmin_vs_twin(   # K3's operand
                torch, kb, q, padded(torch, db, 128 * block), block,
                n=N_MAIN)
    for nq in (687, 768):         # a 100M query slice and its padded tile
        runs[nq, 512, False] = blockmin_vs_twin(
            torch, kb, u_dev[:nq].contiguous(), db, 512)
    log(f"blockmin tensor cores: Q=128 per-query time "
        f"{runs[128, 512, False][1] / 128 * Q / runs[Q, 512, False][1]:.2f}"
        f"x the Q={Q} one (block 512); Q=687 takes "
        f"{runs[687, 512, False][1] / runs[768, 512, False][1]:.1%} of "
        f"Q=768's time for {687 / 768:.1%} of its queries")
    return max(r[0] for r in runs.values()), runs


def dispatch_phase(torch, index, q_dev, scfg):
    """Phase 8: two handles in flight, finalized out of order, equal to
    mih_search on every row."""
    from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                           mih_search_finalize)
    # a batch's order decides which rows its stage budgets spill to the
    # scan tier, so the reversed batch has its own reference run
    rev = q_dev.flip(0)
    want, want_rev = mih_search(index, q_dev, scfg), mih_search(index, rev,
                                                                scfg)
    h1 = mih_search_dispatch(index, q_dev, scfg)
    h2 = mih_search_dispatch(index, rev, scfg)
    check(h1.event is not None and h1.host.is_pinned(),
          "dispatch: no pinned host copy behind a CUDA event")
    r2 = mih_search_finalize(h2)
    r1 = mih_search_finalize(h1)
    for f in want._fields:
        check(torch.equal(getattr(r1, f), getattr(want, f)),
              f"dispatch: {f} != mih_search")
        check(torch.equal(getattr(r2, f), getattr(want_rev, f)),
              f"dispatch (reversed batch, finalized first): {f} != "
              "mih_search")
    check(torch.equal(r2.dists, r1.dists.flip(0)),
          "dispatch: the reversed batch's dists are not the batch's")
    log(f"dispatch/finalize 1M k={scfg.knn}: two handles in flight, "
        f"finalized out of order, equal to mih_search on all {len(q_dev)} "
        f"rows; packed row {tuple(h1.packed.shape)}")


def narrow_phase(torch, kb, kp, dev, scfg):
    """Phase 9: a 64-bit index under uniform queries: the whole batch
    takes the scan tier, which runs the tensor-core blockmin instance at
    W = 2."""
    from verticut_tpu_torch import bits, codes
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index import build_index
    cfg = MIHConfig(bits=64, n_tables=2)
    packed = codes.clustered_codes(0, N_MAIN, 64, n_clusters=N_MAIN // 200,
                                   flip_p=0.02)
    index = build_index(packed, cfg, device=dev)
    u = bits.as_codes(codes.random_codes(98, Q, 64), dev)
    zero_counts(kb, kp)
    launches, res = run_cell(torch, "1M 64-bit (m=2) uniform k=10", index, u,
                             scfg, 256, kb)
    check(launches > 0, "the 64-bit cell launched no blockmin kernel")
    check(kb.launches_by_instance["generic"] == 0,
          "the 64-bit cell launched the generic blockmin instance")
    check(bool((res.radius == 1).all()),
          "the 64-bit uniform cell did not resolve in the scan tier")
    return launches


def scale_phase(torch, kb, dev, k10, k100):
    """Phase 11: bench.py's scale branch at the reference's default 100M
    codes. Returns the phase's blockmin launches."""
    from verticut_tpu_torch import bench, bits, codes
    torch.cuda.reset_peak_memory_stats()
    index, info = bench.make_index(N_SCALE, dev)
    peak = torch.cuda.max_memory_allocated()
    check(info["layout"] == "inline"
          and all(t.entry_ids is None for t in index.tables),
          "100M: expected inline rows without flat id columns")
    index_bytes = sum(4 * (t.entry_rows.numel() + t.directory.se.numel())
                      for t in index.tables)
    log(f"build N={N_SCALE}: generated on the card in {info['gen_s']:.2f} s, "
        f"built in {info['build_s']:.2f} s, pbits "
        f"{index.tables[0].directory.pbits}; peak device memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated), index "
        f"{index_bytes / 2**30:.2f} GiB + codes "
        f"{index.codes.numel() * 4 / 2**30:.2f} GiB")
    q = bench.perturbed_queries(np.random.default_rng(0), index.codes, Q)
    u = bits.as_codes(codes.random_codes(99, Q, 128), dev)
    kb.launches = 0
    out = {}
    with counted_merges() as merges, whole_batch_scans(kb) as scans:
        for name, qs, scfg, n_batches, runs in (
                ("100M k=10", q, k10, 12, 3), ("100M k=100", q, k100, 8, 1),
                ("100M uniform k=10", u, k10, 8, 1)):
            before = kb.launches
            c = bench.cell(index, qs, scfg, n_batches, runs)
            k = scfg.knn
            check(c["handle"] is not None
                  and tuple(c["handle"].packed.shape) == (Q, 2 * k + 3),
                  f"{name}: the result row is not [Q, 2k + 3]")
            check_result(torch, name, c["result"], index.codes, qs, k)
            out[name] = c["result"]
            log(f"cell {name}: first batch {c['warmup_s']:.4f} s, latency "
                f"{', '.join(f'{t:.4f}' for t in c['latency_s'])} s, "
                f"pipelined (depth 4, {n_batches} batches) "
                f"{c['pipelined_batch_s']:.4f} s/batch, {c['qps']:.0f} "
                f"queries/s; radius histogram "
                f"{torch.bincount(c['result'].radius).tolist()}; blockmin "
                f"launches {kb.launches - before}")
    check(scans["split"] == 0, f"100M: {scans['split']} blockmin launches "
          "took a slice of their scan's batch")
    check(merges["pos"] > 0 and merges["packed"] == 0,
          f"100M: the radius steps' merges were {merges}, not all _pos")
    t0 = time.perf_counter()
    od, oi = oracle(q[:N_SCALE_ORACLE], index.codes, 100)
    ud, ui = oracle(u[:N_SCALE_ORACLE], index.codes, 10)
    oracle_s = time.perf_counter() - t0
    for name, (d, i) in (("100M k=10", (od[:, :10], oi[:, :10])),
                         ("100M k=100", (od, oi)),
                         ("100M uniform k=10", (ud, ui))):
        r = out[name]
        check(torch.equal(r.dists[:N_SCALE_ORACLE], d)
              and torch.equal(r.ids[:N_SCALE_ORACLE], i),
              f"{name}: != the popcount oracle")
    log(f"100M: all three cells equal the popcount oracle on "
        f"{N_SCALE_ORACLE} queries, dists and ids ({oracle_s:.1f} s for "
        f"two scans); radius steps merged by the _pos selections "
        f"({merges['pos']} merges, 0 packed); blockmin launches "
        f"{kb.launches}, each on its scan's whole batch (scans of "
        f"{sorted(set(scans['scans']))} queries)")
    return kb.launches


def bucket_phase(torch, kb, kp, dev, packed, q_dev, k10):
    """Phase 12: the bucket directories at 1M codes, each engine through
    both drivers against the oracle and (at m = 4) the range engine.
    Returns the phase's blockmin launches by instance."""
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.index import directory as dir_lib
    from verticut_tpu_torch.search import mih_search
    cfg4, cfg8 = MIHConfig(bits=128, n_tables=4), MIHConfig(bits=128,
                                                           n_tables=8)
    rng_index = build_index(packed, cfg4, device=dev)
    want = mih_search(rng_index, q_dev, k10)
    od, oi = oracle(q_dev[:256], rng_index.codes, k10.knn)
    del rng_index
    zero_counts(kb, kp)
    for name, cfg, kw, kind in (
            ("m=8 default (auto)", cfg8, {}, dir_lib.DenseDirectory),
            ("m=8 default + bitmap", cfg8, {"with_bitmap": True},
             dir_lib.DenseDirectory),
            ("m=4 sorted", cfg4, {"directory": "sorted"},
             dir_lib.SortedDirectory),
            ("m=4 prefix", cfg4, {"directory": "prefix"},
             dir_lib.PrefixDirectory),
            ("m=4 hash", cfg4, {"directory": "hash"},
             dir_lib.HashDirectory)):
        index, build_s = timed(torch, lambda: build_index(packed, cfg,
                                                          device=dev, **kw))
        check(all(isinstance(t.directory, kind) for t in index.tables),
              f"{name}: built {type(index.tables[0].directory).__name__}")
        for fused in (True, False):
            scfg = dataclasses.replace(
                k10, fused=fused, use_bitmap=index.tables[0].bitmap is not None)
            before = dict(kb.launches_by_instance)
            mih_search(index, q_dev, scfg)
            res, warm = timed(torch, lambda: mih_search(index, q_dev, scfg))
            label = f"1M bucket {name} fused={fused}"
            check_result(torch, label, res, index.codes, q_dev, k10.knn)
            ties = (tie_equal(torch, f"{label} vs the oracle",
                              res._replace(dists=res.dists[:256],
                                           ids=res.ids[:256]), od, oi),
                    tie_equal(torch, f"{label} vs the range engine", res,
                              want.dists, want.ids))
            log(f"{label}: build {build_s:.3f} s, warm batch {warm:.4f} "
                f"s/batch; radius histogram "
                f"{torch.bincount(res.radius).tolist()}; oracle (256): "
                f"{ties[0]} rows kept other ids at the kth distance; range "
                f"engine (every row): {ties[1]}; blockmin launches by "
                f"instance "
                f"{ {k: kb.launches_by_instance[k] - before[k] for k in before} }")
        del index
        torch.cuda.empty_cache()
    return dict(kb.launches_by_instance)


def billion_phase(torch, kb, kp, dev, k10):
    """Phase 13: 1B codes on one card through bench.py's scale path.
    Returns the phase's blockmin launches by instance."""
    from verticut_tpu_torch import bench, bits, codes
    torch.cuda.reset_peak_memory_stats()
    index, info = bench.make_index(N_BILLION, dev)
    peak = torch.cuda.max_memory_allocated()
    check(info["layout"] == "compact"
          and all(t.entry_ids is None and t.entry_rows is None
                  for t in index.tables),
          "1B: expected the compact layout without flat id columns")
    index_bytes = sum(4 * (t.entry_idrows.numel() + t.directory.se.numel())
                      for t in index.tables)
    log(f"build N={N_BILLION}: generated on the card in {info['gen_s']:.2f} "
        f"s, built in {info['build_s']:.2f} s, pbits "
        f"{index.tables[0].directory.pbits}; peak device memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated), index "
        f"{index_bytes / 2**30:.2f} GiB + codes "
        f"{index.codes.numel() * 4 / 2**30:.2f} GiB")
    q = bench.perturbed_queries(np.random.default_rng(0), index.codes, Q)
    u = bits.as_codes(codes.random_codes(99, Q, 128), dev)
    zero_counts(kb, kp)
    out = {}
    with counted_merges() as merges, whole_batch_scans(kb) as scans:
        for name, qs in (("1B k=10", q), ("1B uniform k=10", u)):
            before = kb.launches
            c = bench.cell(index, qs, k10, 4, 1)
            check(c["handle"] is not None and tuple(
                c["handle"].packed.shape) == (Q, 2 * k10.knn + 3),
                f"{name}: the result row is not [Q, 2k + 3]")
            check_result(torch, name, c["result"], index.codes, qs, k10.knn)
            out[name] = c["result"]
            log(f"cell {name}: first batch {c['warmup_s']:.4f} s, latency "
                f"{c['latency_s'][0]:.4f} s, pipelined (depth 4, 4 batches) "
                f"{c['pipelined_batch_s']:.4f} s/batch, {c['qps']:.0f} "
                f"queries/s; radius histogram "
                f"{torch.bincount(c['result'].radius).tolist()}; blockmin "
                f"launches {kb.launches - before}")
    check(merges["pos"] > 0 and merges["packed"] == 0,
          f"1B: the radius steps' merges were {merges}, not all _pos")
    check(scans["split"] == 0, f"1B: {scans['split']} blockmin launches "
          "took a slice of their scan's batch")
    check(kb.launches_by_instance["generic"] == 0 and kb.launches > 0,
          f"1B: blockmin launches {kb.launches_by_instance}")
    t0 = time.perf_counter()
    for name, qs in (("1B k=10", q), ("1B uniform k=10", u)):
        d, i = oracle(qs[:N_BILLION_ORACLE], index.codes, k10.knn,
                      chunk=1 << 18)
        r = out[name]
        check(torch.equal(r.dists[:N_BILLION_ORACLE], d)
              and torch.equal(r.ids[:N_BILLION_ORACLE], i),
              f"{name}: != the popcount oracle")
    log(f"1B: both cells equal the popcount oracle on {N_BILLION_ORACLE} "
        f"queries, dists and ids ({time.perf_counter() - t0:.1f} s for two "
        f"scans); radius steps merged by the _pos selections "
        f"({merges['pos']} merges, 0 packed); blockmin launches "
        f"{kb.launches_by_instance}, each on its scan's whole batch (scans "
        f"of {sorted(set(scans['scans']))} queries)")
    return dict(kb.launches_by_instance)


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
    from verticut_tpu_torch.bench import perturbed_queries
    from verticut_tpu_torch.oracle_drive import run_cells

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
        text = _build.build_logs.get(m.NAME, "")
        for fn, spill, regs in re.findall(
                r"Function properties for (\S+)\s+\d+ bytes stack frame, "
                r"(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers",
                text):
            tc = re.search(r"tc_kernelILi(\d+)ELi(\d+)E", fn)
            name = (f"tensor-core W={tc[1]} BT={tc[2]}" if tc else
                    re.sub(r"^_Z\w*?\d+(?=[a-z_]+_kernel)|(?<=_kernel)\w*$",
                           "", fn))
            log(f"    {name}: {regs} registers, {spill} bytes spill stores")
        # ptxas's warning that it serialised a kernel's wgmma instructions
        log(f"    wgmma serialisation warnings: "
            f"{text.count('mma_async instructions are serialized')}")

    # 3. kernels vs twins at the paths' shapes
    packed = codes.clustered_codes(0, N_MAIN, 128, n_clusters=N_MAIN // 200,
                                   flip_p=0.02)
    db = bits.as_codes(packed, dev)
    q_dev = perturbed_queries(np.random.default_rng(0), db, Q)
    u_dev = bits.as_codes(codes.random_codes(99, Q, 128), dev)
    err, tc = tensor_phase(torch, kb, u_dev, db)
    max_err = {"blockmin": err}
    pw = kernel_vs_twin(torch, f"pairwise Q={Q} N={N_PAIRWISE}", kp.pairwise,
                        kp.pairwise_reference, (u_dev, db[:N_PAIRWISE]),
                        bound=pairwise_bound(Q, N_PAIRWISE, 4))
    max_err["pairwise"] = pw[0]
    pw_lib = cdist_ms(torch, u_dev, db[:N_PAIRWISE],
                      kp.pairwise(u_dev, db[:N_PAIRWISE]))
    log(f"torch.cdist(p=0) on 0/1 float bits, Q={Q} N={N_PAIRWISE}: "
        f"{pw_lib:.3f} ms (equal to the pairwise kernel)")
    torch.cuda.empty_cache()
    err, gen_bm, gen_pw, w2_bm = generic_phase(torch, kb, kp, u_dev, db, dev)
    max_err = {k: max(v, err) for k, v in max_err.items()}
    max_err["blockmin"] = max(max_err["blockmin"],
                              instances_phase(torch, kb, dev))

    # 4. the main path, counted
    cfg = MIHConfig(bits=128, n_tables=4)
    k10 = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    k100 = SearchConfig(knn=100, candidate_cap=8192, max_enum_radius=5)
    zero_counts(kb, kp)
    t0 = time.perf_counter()
    index = build_index(packed, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"build N={N_MAIN}: {time.perf_counter() - t0:.3f} s, pbits "
        f"{index.tables[0].directory.pbits}")
    run_cell(torch, "1M k=10", index, q_dev, k10, 256, kb)
    run_cell(torch, "1M k=100", index, q_dev, k100, 256, kb)
    uniform, _ = run_cell(torch, "1M uniform k=10", index, u_dev, k10, 256,
                          kb)
    main_launches = kb.launches
    main_by_instance = dict(kb.launches_by_instance)
    log(f"main path blockmin launches by instance: {main_by_instance}")
    check(uniform > 0, "the uniform cell launched no blockmin kernel")
    check(main_by_instance["tensor"] > 0,
          "the main path launched no tensor-core blockmin kernel")

    # 5.-8. the linear-scan methods, the loop driver, approximate mode,
    # dispatch / finalize
    linear = linear_phase(torch, kb, kp, index.codes, u_dev)
    loop_phase(torch, kb, index, q_dev, u_dev, k10)
    approx_phase(torch, kb, index, q_dev, k10)
    dispatch_phase(torch, index, q_dev, k10)
    del index, u_dev, db
    torch.cuda.empty_cache()

    # 9. a 64-bit index: the tensor-core instance at W = 2 on the scan tier
    narrow_phase(torch, kb, kp, dev, k10)
    torch.cuda.empty_cache()

    # 10. the oracle drive at wide k
    t0 = time.perf_counter()
    for c in run_cells(N_MAIN, 1024, (500, 1000), dev):
        check(c["ok"], f"oracle drive: {c}")
    log(f"oracle drive N={N_MAIN} k=500,1000 (clustered and uniform): all "
        f"cells equal the oracle in dists and ids "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # 11. scale
    zero_counts(kb, kp)
    scale_launches = scale_phase(torch, kb, dev, k10, k100)
    scale_by_instance = dict(kb.launches_by_instance)
    log(f"100M phase blockmin launches by instance: {scale_by_instance}")
    check(scale_by_instance["tensor"] > 0,
          "the 100M phase launched no tensor-core blockmin kernel")
    torch.cuda.empty_cache()

    # 12. the bucket directories (counts zeroed inside)
    bucket_by_instance = bucket_phase(torch, kb, kp, dev, packed, q_dev, k10)
    log(f"bucket phase blockmin launches by instance: {bucket_by_instance}")
    check(bucket_by_instance["generic"] == 0,
          "the bucket phase launched the generic blockmin instance")
    del q_dev
    torch.cuda.empty_cache()

    # 13. 1B codes (counts zeroed inside)
    billion_by_instance = billion_phase(torch, kb, kp, dev, k10)

    src = "verticut_tpu/ops/pallas/linear_scan.py"
    bm_bound, bm_by = blockmin_bound(Q, N_MAIN, N_MAIN, 4, 512)
    print(json.dumps({"kernels": [
        {"name": "blockmin", "route": "cuda",
         "source": "verticut_tpu_torch/csrc/blockmin.cu",
         "replaces": f"{src}:106,295,346", "instance": kb.instance(4, 512),
         "launches": main_launches, "launches_by_instance": main_by_instance,
         "scale_launches": scale_launches,
         "scale_launches_by_instance": scale_by_instance,
         "bucket_launches_by_instance": bucket_by_instance,
         "launches_1b": sum(billion_by_instance.values()),
         "launches_1b_by_instance": billion_by_instance,
         "max_abs_err": max_err["blockmin"],
         "ms": tc[Q, 512, False][1], "plain_ms": tc[Q, 512, False][2],
         "bound_ms": bm_bound, "bound_by": bm_by,
         "bound_what": "int8 tensor cores", "library_ms": None,
         "shape": f"Q={Q} N={N_MAIN} W=4 block=512",
         "block128_ms": tc[Q, 128, False][1],
         "q128_ms": tc[128, 512, False][1],
         "q128_bound_ms": blockmin_bound(128, N_MAIN, N_MAIN, 4, 512)[0],
         "w2_ms": w2_bm[1],
         "w2_bound_ms": blockmin_bound(Q, N_MAIN, N_MAIN, 2, 512)[0],
         "generic_ms": gen_bm[1], "generic_plain_ms": gen_bm[2],
         "generic_shape": f"Q={Q} N={N_MAIN} W=4 block=1000"},
        {"name": "pairwise", "route": "cuda",
         "source": "verticut_tpu_torch/csrc/pairwise.cu",
         "replaces": f"{src}:419", "instance": "fast",
         "launches": linear["pairwise"], "max_abs_err": max_err["pairwise"],
         "ms": pw[1], "plain_ms": pw[2],
         "bound_ms": pairwise_bound(Q, N_PAIRWISE, 4), "bound_by": "bytes",
         "bound_what": "device-memory stores", "library_ms": pw_lib,
         "shape": f"Q={Q} N={N_PAIRWISE} W=4",
         "generic_ms": gen_pw[1], "generic_plain_ms": gen_pw[2],
         "generic_shape": f"Q={Q} N={N_PAIRWISE} W=2"}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
