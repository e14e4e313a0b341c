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
 3b. the fetch + score kernel == its twins, bit for bit, at the cells'
     stage-1 shapes (inline rows over 100M entries, W = 4; compact id rows
     over 1B entries and their 16 GB of codes, skewed ranges; chunk
     budgets from _cap_for_radius), each timed beside its byte bound, and
     on ragged cases (Q = 37, W = 1, 3 and 8, compact codes off their
     16-byte grid);
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
     order, equal to mih_search on every row; how long a dispatch takes
     to return beside one batch's latency; two handles in flight against
     two batches back to back (s/batch, results equal);
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
     full-batch corpus chunks, not query slices); two handles in flight
     against two batches back to back at k = 10, as in phase 8;
 11b. the service: ImageSearchServer on the 1M index of phase 4 and on the
     100M index, prewarmed (buckets 8 to 128), the port's client over TCP
     on localhost: search_image_by_id from 1 (1M only), 16 and 64 client
     threads, a socket each (at 1M also 64 threads over the client's
     default pool of 20, as the load generator runs), and a search_batch
     load of uniform codes (the scan tier);
     QPS and p50/p90/p99 per load beside the card's name and power limit;
     every served answer against mih_search on the same rows (dists on
     every row, ids below the kth distance, every id's true distance),
     the first 64 rows against the popcount oracle; blockmin must launch,
     on the tensor-core instance only;
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
 14. the encoders: 1M clustered features at D = 128 made on the card;
     ITQEncoder.fit on a 20,000-row sample (50 iterations) and
     RandomProjectionLSH.create; encode_corpus of all 1M rows by each (fit
     s, encode s, codes/s); on 4,096 rows the card's codes equal the same
     encoder's encode on the CPU except at bits whose projection lies
     within float rounding of 0 (|z| <= 1e-5 * the sum of the product's
     absolute terms; the bits within 1e-5 of 0 are counted too); then
     build_index on the ITQ codes and a k = 10 batch of 8192 perturbed
     rows, dists equal to the popcount oracle on 256 and ids below the
     kth distance;
 15. a world of one on NCCL (parallel.single_device_mesh): the inline
     sharded engine built on phase 4's 1M corpus, 8192 queries at k = 10,
     fused and fused=False: dists, radius, n_probes, n_nonempty and
     n_cands equal to mih_search on the same corpus and driver, ids below
     the kth distance, the first 256 rows equal to the oracle; s/batch
     beside mih_search's;
 15b. a padded corpus in the same world: phase 4's corpus and 37 uniform
     codes (N = 1,000,037, which both sharded builds pad with zero codes)
     under the zero code and codes with 1 to 8 set bits, nearer the pads
     than any row: sharded_linear_search on both indexes,
     sharded_mih_search fused and loop, and sharded_compact_search, each
     equal to the oracle on the unpadded corpus in dists and ids;
 16. the compact sharded engine on the reference's default 100M corpus
     (made on the card) in the same world: build s, peak device memory,
     memory_stats(), s/batch at k = 10 over 8192 clustered queries, 128
     rows against the oracle; the scan tier timed apart at its 128-query
     shape over the 100M codes, in one call: the block-min tier as the
     engines run it and the scan_popcount tier it replaced, both equal to
     the oracle; the save/load round trip at 1M;
 17. ImageSearchServer(sharded=True) on phase 15's index: 16 client
     threads of search_image_by_id, QPS and p50/p90/p99, every answer's
     dists equal to sharded_mih_search on the same rows (ids below the
     kth distance).
 18. the command-line tools (verticut_tpu_torch/tools), each main()
     called in this process on phase 4's corpus written to a code file
     (and 200 uniform queries to another): build_index inline, --compact,
     --bitmap --ntables 8 (each file equal to the same build in memory)
     and --mesh 1x1x1 (a spawned rank; the shards equal the build in a
     world of one); search -q 12345 -k 100, -f -k 10 (the oracle's dists,
     its ids below the kth distance), -f -k 10 -a (mih_search's
     approximate answer) and --mesh 1x1x1 (the single-device lines and
     stat line); linear_search popcount == matmul == the search's dists;
     integrity_check on the file (ok), on a copy with one id flipped (exit
     1) and --synthetic 100M (ok; build and check s, peak memory);
     generate_bitmap --ntables 8 byte-equal to the index's bitmaps;
     accuracy_sweep at 1M x 256 (two subprocesses), every field but the
     times equal to ACCURACY_r05.json's; bigann --synth 1M (1,000
     queries, shortlists 10, 100, 1000; recall, ratio, seconds, QPS), the
     shortlist-1000 answer equal to the oracle on 64 queries. Blockmin
     must launch in the in-process tools, on the tensor-core instance
     only, and pairwise not at all.
 19. the key-value store and the last five tools: (a) the reference's
     streaming build, every (table, substring) -> (id, code) of phase 4's
     1M corpus appended through BucketStore(DHTStore()) (appends/s, the
     DHT's stats), every bucket's ids (in CSR order) and codes equal to
     the card's build_index(directory="hash") (its seconds); (b)
     kv_loadtest --backend dht -n 100000, direct and server read modes,
     one store and --n_shards 4; (c) perf_sweep search --n 1000000 --q
     512,8192 --k 10,100 --repeats 3 on the card, every answer equal to
     the popcount oracle on its first 64 queries, any blockmin launch on
     the tensor-core instance; (d) collective_bench --max_pow 17 --mesh
     1x1x1 (gathers from a 2^24-word table in device memory; an
     all_gather in a spawned world of one on NCCL); (e) multiproc_demo
     --mesh 1x1x1 on the card, its three checks true; (f) tcp_echo's
     self-test. Each with the card's name and power limit.
 20. the profiling and measurement tools, each main() called in this
     process (virtual_scale_run spawns its rank): profile_stages2 and
     profile_stages (the radius step's components at stage-1 and stage-2
     shapes, launches and device ms of each), profile_tiers,
     profile_fused_ablate (R = 4), qscale_bench (6 batches a cell) and
     pipeline_overlap_bench at 1M codes; profile_scan and int8_scan_bench
     at 16M (both blockmin instances); gather_bench (16M) and
     microbench_r5 (1M); compact_chip_bench and virtual_scale_run --mesh
     1x1x1 (a spawned rank on NCCL) at 20M, phase 16 running the compact
     layout at 100M. Every tool's checks must hold; each record is logged
     with the card's name and power limit (and written whole to
     $VERTICUT_PROFILE_OUT/<tool>.json where that is set); the phase's
     seconds are printed.
Phases 4 to 20 each set the kernels' launch counts (blockmin's also by
instance) to 0 before they run and read them after; the main path's
(phases 4, 11, 11b, 12 and 13) must go through the tensor-core instance,
the range engine's radius steps through the fetch + score kernel (phase
4: one launch per table and radius step; 11, 13 and the inline sharded
engine of 15: at least one),
and the sharded engines' scan tier and linear fallback (phases 15-17)
run the block-min scan over each rank's real rows: every blockmin launch
there on the tensor-core instance, at least one wherever rows went to
the tier, and no pairwise launch. The line before the last is a
JSON record of the kernels; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

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
    from verticut_tpu_torch.kernels import fetch_score as kf
    kb.launches = kp.launches = kf.launches = 0
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
    """Exact comparison of ``kernel(*args)`` and ``twin(*args)`` (a tensor
    or a tuple of tensors each); returns
    (max_abs_err, kernel ms averaged over 10 launches after a warm-up,
    twin ms of one call). ``bound``: the least time in ms, printed with
    the kernel's share of it."""
    got = kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = twin(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0
    for g, x in zip(*((t,) if isinstance(t, torch.Tensor) else t
                      for t in (got, want)), strict=True):
        check(g.shape == x.shape,
              f"{name}: kernel shape {tuple(g.shape)} != {tuple(x.shape)}")
        err = max(err, int((g.long() - x.long()).abs().max())
                  if g.numel() else 0)
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
    launch counts stay the wrapper's. Scans run on the dispatch workers,
    two at once: each thread keeps its own stack of open scans."""
    from verticut_tpu_torch.ops import hamming
    from verticut_tpu_torch.search import single
    rec = {"scans": [], "split": 0}
    scan, launch = hamming.scan_blockmin, kb.blockmin
    local, lock = threading.local(), threading.Lock()

    def scan_rec(queries, *a, **kw):
        cur = local.__dict__.setdefault("cur", [])
        with lock:
            rec["scans"].append(queries.shape[0])
        cur.append(queries.shape[0])
        try:
            return scan(queries, *a, **kw)
        finally:
            cur.pop()

    def launch_rec(queries, *a, **kw):
        cur = local.__dict__.setdefault("cur", [])
        with lock:
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
    lock = threading.Lock()

    def counted(name, fn):
        def wrapper(*a, **kw):
            with lock:
                merges[name] += 1
            return fn(*a, **kw)
        return wrapper

    with patched((topk, "merge_strips_dedup_pos",
                  counted("pos", topk.merge_strips_dedup_pos)),
                 (topk, "merge_strips_packed",
                  counted("packed", topk.merge_strips_packed))):
        yield merges


@contextlib.contextmanager
def counted_steps():
    """Count the range engine's radius steps (``single.radius_step``, each
    of which fetches and scores every table once). Yields a dict whose
    ``steps`` is the count."""
    from verticut_tpu_torch.search import single
    steps = {"steps": 0}
    lock = threading.Lock()
    step = single.radius_step

    def counted(*a, **kw):
        with lock:
            steps["steps"] += 1
        return step(*a, **kw)

    with patched((single, "radius_step", counted)):
        yield steps


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


def fetch_score_table(torch, dev, compact, n, w, nq, seed, hot=0.02):
    """A synthetic range table of ``n`` entries on the card, in the inline
    or the compact layout, and stage-1 descriptors of ``nq`` random
    queries over it. Ids are random in ``[0, n)`` with 1% pad ids ``-1``
    (and the last block's tail padded, as a build pads it); each query
    probes ``1 + pbits`` ranges (radii 0 and 1 over the prefix the build
    would pick) at random starts, of Poisson(n / 2^pbits) entries, and a
    share ``hot`` of the probes hit a hot range of 4-40 blocks (skew).
    The chunk budget is the range engine's: ``_cap_for_radius`` of the
    1M/100M cells' config at radii (0, 1), over ``blk``. Returns
    ``(args, blk, chb, pbits)``, ``args`` in the layout's entry order."""
    from verticut_tpu_torch.config import SearchConfig
    from verticut_tpu_torch.index import directory as dir_lib
    from verticut_tpu_torch.index.mih import ID_ROW_BLOCK, entry_block_size
    from verticut_tpu_torch.ops import chunks
    from verticut_tpu_torch.search import single
    g = torch.Generator(device=dev).manual_seed(seed)
    blk = ID_ROW_BLOCK if compact else entry_block_size(w)
    pbits = dir_lib.pick_range_pbits(n, 32 * w // 4, blk)
    scfg = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    chb = max(4, single._cap_for_radius(scfg, n, (0, 1), pbits, blk) // blk)
    nb = -(-n // blk)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                             device=dev, dtype=torch.int32)

    ids = torch.randint(0, n, (nb, blk), generator=g, device=dev,
                        dtype=torch.int32)
    ids[torch.rand((nb, blk), generator=g, device=dev) < 0.01] = -1
    ids.view(-1)[n:] = -1
    if compact:
        args = [ids, words(n, w)]
    else:
        rows = words(nb, blk * (w + 1))
        rows[:, :blk] = ids
        args = [rows]
    del ids
    h = 1 + pbits
    starts = torch.randint(0, n, (nq, h), generator=g, device=dev,
                           dtype=torch.int32)
    counts = torch.poisson(torch.full((nq, h), n / 2.0 ** pbits,
                                      device=dev), generator=g)
    hot_n = torch.randint(4 * blk, 40 * blk, (nq, h), generator=g,
                          device=dev).to(counts.dtype)
    hot_p = torch.rand((nq, h), generator=g, device=dev) < hot
    counts = torch.minimum(torch.where(hot_p, hot_n, counts).to(torch.int32),
                           n - starts)
    blk_id, lo, hi, _, _ = chunks.chunk_descriptors(
        starts, counts, blk=blk, chb=chb, n_blocks=nb)
    args += [blk_id, lo, hi, words(nq, w)]
    return args, blk, chb, pbits


def fetch_score_bound(compact, args, ids, blk, w):
    """The least time of a fetch + score call, ms, at the memory rate: the
    outputs written once (8 B a slot), the descriptors (12 B a chunk) and
    queries read once, 4 B of id per in-window slot and per valid slot its
    code, W words of the inline row or one 32-byte sector of the codes
    (the least a scattered read of a code moves); and the valid slots."""
    blk_id, lo, hi = args[-4:-1]
    nq, chb = blk_id.shape
    in_window = int((hi.clamp(0, blk) - lo.clamp(0, blk)).clamp(min=0).sum())
    valid = int((ids >= 0).sum())
    code = 32 if compact else 4 * w
    nbytes = (8 * nq * chb * blk + 12 * nq * chb + 4 * nq * w
              + 4 * in_window + code * valid)
    return nbytes / H100_BYTES * 1e3, valid


def fetch_score_pair(kf, compact, blk):
    """The layout's kernel entry and twin, each called as ``f(*args)``."""
    if compact:
        return kf.fetch_score_idrows, kf.fetch_score_idrows_reference
    return (functools.partial(kf.fetch_score_blocks, blk=blk),
            functools.partial(kf.fetch_score_blocks_reference, blk=blk))


def fetch_score_phase(torch, kf, dev):
    """Phase 3b: the fetch + score kernel against its twins, both layouts,
    at the cells' stage-1 shapes (inline rows over 100M entries at W = 4;
    id rows over 1B entries and their codes, skewed), each time beside its
    bound, then ragged cases (W = 1, 3, 8; the W = 8 compact codes one
    word off their allocation). Returns ``{layout: (err, ms, plain_ms,
    bound_ms, shape)}`` of the cell shapes."""
    out = {}
    for compact, n in ((False, N_SCALE), (True, N_BILLION)):
        layout = "compact" if compact else "inline"
        args, blk, chb, pbits = fetch_score_table(torch, dev, compact, n, 4,
                                                  Q, seed=31 + compact)
        kernel, twin = fetch_score_pair(kf, compact, blk)
        _, ids = kernel(*args)
        bound, valid = fetch_score_bound(compact, args, ids, blk, 4)
        del ids
        shape = f"Q={Q} CHB={chb} blk={blk} W=4 N={n}"
        err, ms, plain_ms = kernel_vs_twin(
            torch, f"fetch_score {layout} {shape} (pbits {pbits}, "
            f"{valid} valid slots)", kernel, twin, args, bound=bound)
        out[layout] = (err, ms, plain_ms, bound, shape)
        del args
        torch.cuda.empty_cache()
    for w in (1, 3, 8):
        for compact in (False, True):
            args, blk, chb, _ = fetch_score_table(
                torch, dev, compact, 100_003, w, 37, seed=w, hot=0.2)
            if compact and w == 8:      # rows off the 16- and 8-byte grid
                spare = torch.empty(args[1].numel() + 1, dtype=torch.int32,
                                    device=dev)
                args[1] = spare[1:].view(args[1].shape).copy_(args[1])
            kernel, twin = fetch_score_pair(kf, compact, blk)
            check(all(torch.equal(a, b)
                      for a, b in zip(kernel(*args), twin(*args))),
                  f"fetch_score {'compact' if compact else 'inline'} W={w} "
                  f"Q=37 CHB={chb} blk={blk}: kernel != twin")
    log("fetch_score ragged cases (Q=37, W=1/3/8, both layouts, the W=8 "
        "compact codes off their 16-byte grid): kernel == twin")
    return out


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
    in_flight(torch, f"1M k={scfg.knn}", index, q_dev, scfg, want)


def in_flight(torch, name, index, q, scfg, want, reps=5):
    """Two batches back to back against two handles in flight, in turns,
    ``reps`` times each (``breakdown.profile_pair``, unprofiled): every
    result equal to ``want``. Prints the medians' s/batch and how long a
    dispatch takes to return beside one batch's latency; asserts
    equality, not speed."""
    from verticut_tpu_torch.breakdown import profile_pair

    def equal(mode, res):
        for f in want._fields:
            check(torch.equal(getattr(res, f), getattr(want, f)),
                  f"{name}: {mode} {f} != mih_search")

    rec = profile_pair(index, q, scfg, reps=reps, check=equal, profile=False)
    seq, par = rec["back_to_back"], rec["in_flight"]
    log(f"{name}: mih_search_dispatch returned in "
        f"{par['dispatch_s'] * 1e3:.2f} ms (one batch's latency "
        f"{seq['batch_s'] * 1e3:.2f} ms); two handles in flight "
        f"{par['batch_s']:.4f} s/batch against two batches back to back "
        f"{seq['batch_s']:.4f} s/batch (medians of {reps}; runs in flight "
        f"{', '.join(f'{t:.4f}' for t in par['runs_s'])}, back to back "
        f"{', '.join(f'{t:.4f}' for t in seq['runs_s'])}); results equal")
    return rec


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
    codes. Returns the phase's blockmin launches, in all and by instance
    (both read before the in-flight comparison), and the index."""
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
    launches, by_instance = kb.launches, dict(kb.launches_by_instance)
    in_flight(torch, "100M k=10", index, q, k10, out["100M k=10"])
    return launches, by_instance, index


def served_rows(torch, name, rows, k):
    """Served answers (lists of ``[id, dist]`` pairs) as ``(dists, ids)``
    host tensors ``[R, k]``; every row must hold k."""
    check(all(len(r) == k for r in rows), f"{name}: a served row holds "
          f"fewer than {k} results")
    pairs = torch.tensor(rows, dtype=torch.int32).reshape(len(rows), k, 2)
    return pairs[..., 1].contiguous(), pairs[..., 0].contiguous()


def check_served(torch, name, index, q, dists, ids, k):
    """Served ``(dists, ids)`` of the query rows ``q`` (on the card)
    against the port's mih_search on the same rows: dists on every row,
    ids below the kth distance (counting the rows with other ids at it),
    every id's true distance; the first 64 rows against the popcount
    oracle. Returns the two tie counts."""
    from verticut_tpu_torch import codes
    from verticut_tpu_torch.config import SearchConfig
    from verticut_tpu_torch.search import mih_search
    served = SimpleNamespace(dists=dists, ids=ids)
    want = mih_search(index, q, SearchConfig(knn=k))
    true_d = codes.hamming_distance(index.codes[ids.to(q.device).long()],
                                    q[:, None, :])
    check(torch.equal(true_d.cpu(), dists),
          f"{name}: served ids disagree with their dists")
    od, oi = oracle(q[:64], index.codes, k)
    first = SimpleNamespace(dists=dists[:64], ids=ids[:64])
    return (tie_equal(torch, f"{name} vs mih_search", served, want.dists,
                      want.ids),
            tie_equal(torch, f"{name} vs the oracle", first, od, oi))


def service_phase(torch, kb, kp, indexes, smi):
    """Phase 11b: the RPC service on each ``(name, index, by-id loads)``
    over TCP on localhost; a load is ``(client threads, requests, client
    pool sockets)``. Returns the blockmin launches by instance that the
    served requests made, summed over the indexes: counted from after the
    prewarm until the server stops, before the answers are checked."""
    from verticut_tpu_torch import bits, codes
    from verticut_tpu_torch.service import ImageSearchClient, ImageSearchServer
    from verticut_tpu_torch.tools.image_search_test import pcts, run_load
    k, rows, n_batch, threads_batch = 10, 256, 4, 4
    by_instance = dict.fromkeys(kb.INSTANCES, 0)
    for name, index, loads in indexes:
        t_phase = time.perf_counter()
        srv = ImageSearchServer(index, port=0, default_knn=k).start()
        clients = {}
        try:
            t0 = time.perf_counter()
            srv.prewarm(max_rows=128)
            log(f"service {name}: prewarm (buckets 8-128) "
                f"{time.perf_counter() - t0:.2f} s")
            zero_counts(kb, kp)
            rng = np.random.default_rng(len(name))
            qids, served = [], {}
            for threads, n, pool in loads:
                if pool not in clients:
                    clients[pool] = ImageSearchClient(port=srv.port,
                                                      pool=pool, timeout=300)
                cli = clients[pool]
                ids = rng.integers(0, index.n, n).tolist()
                # as the load generator: the arrival shapes and the
                # client's connections first, then the measured load
                run_load(cli, ids[:2 * max(threads, 4)], k, threads)
                dt, lats, res = run_load(cli, ids, k, threads)
                qids += ids
                served.update(res)
                log(f"service {name} search_image_by_id k={k}, "
                    f"{max(threads, 1)} client thread(s) over {pool} "
                    f"socket(s), {n} requests: {n / dt:.1f} QPS, "
                    f"p50/p90/p99 {pcts(lats)} ms; {smi}")
            cli = clients[max(clients)]
            qids = sorted(set(qids))
            # uniform codes in search_batch requests: the scan tier
            u = codes.random_codes(99, n_batch * threads_batch * rows, 128)
            blobs = [codes.unpack_to_bytes(u[i:i + rows]).tobytes()
                     for i in range(0, len(u), rows)]
            lats, got, errs = [], [None] * len(blobs), []

            def batch_client(j):
                try:
                    for b in range(j, len(blobs), threads_batch):
                        t1 = time.perf_counter()
                        got[b] = cli.search_batch(blobs[b], k)
                        lats.append(time.perf_counter() - t1)
                except Exception as e:  # noqa: BLE001 — reported below
                    errs.append(e)

            t0 = time.perf_counter()
            ts = [threading.Thread(target=batch_client, args=(j,))
                  for j in range(threads_batch)]
            [t.start() for t in ts]
            [t.join(timeout=300) for t in ts]
            dt = time.perf_counter() - t0
            check(not errs and not any(t.is_alive() for t in ts),
                  f"service {name} search_batch: {errs or 'a client hung'}")
            log(f"service {name} search_batch k={k}, {threads_batch} client "
                f"threads, {len(blobs)} requests of {rows} uniform codes: "
                f"{len(blobs) / dt:.1f} requests/s ({len(u) / dt:.0f} "
                f"codes/s), p50/p90/p99 {pcts(sorted(lats))} ms; {smi}")
            st = cli.stats()
        finally:
            for c in clients.values():
                c.close()
            srv.stop()
        served_by = dict(kb.launches_by_instance)
        for inst, n in served_by.items():
            by_instance[inst] += n
        dev = index.device
        q_id = index.codes[torch.tensor(qids, device=dev)]
        d_id, i_id = served_rows(torch, f"service {name}",
                                 [served[q] for q in qids], k)
        d_u, i_u = served_rows(torch, f"service {name} batch",
                               [r for g in got for r in g], k)
        ties = [check_served(torch, f"service {name} {what}", index, q, d, i,
                             k)
                for what, q, d, i in (("by id", q_id, d_id, i_id),
                                      ("batch", bits.as_codes(u, dev), d_u,
                                       i_u))]
        log(f"service {name}: {len(qids)} distinct by-id rows and {len(u)} "
            f"uniform rows served, every answer equal to mih_search in dists "
            f"and in ids below the kth distance (rows with other ids at it: "
            f"by id {ties[0][0]}, batch {ties[1][0]}; vs the oracle on 64: "
            f"{ties[0][1]}, {ties[1][1]}), every id at its distance; "
            f"{st['n_requests']} rows in {st['n_batches']} batches; blockmin "
            f"launches while serving {served_by}; phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        check(served_by["tensor"] > 0,
              f"service {name}: the served requests launched no "
              f"tensor-core blockmin kernel ({served_by})")
    check(by_instance["tensor"] > 0 and by_instance["generic"] == 0,
          f"service: blockmin launches {by_instance}")
    return by_instance


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
            torch.cuda.reset_peak_memory_stats()
            c = bench.cell(index, qs, k10, 4, 1)
            peak = torch.cuda.max_memory_allocated()
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
                f"launches {kb.launches - before}; peak device memory over "
                f"the cell (the depth-4 pipeline) {peak / 2**30:.2f} GiB "
                f"(max_memory_allocated)")
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


def near_zero_bits(torch, enc, x):
    """The CPU encoder's fp32 projections of ``x`` and the sums of their
    products' absolute terms (bounding each projection's rounding)."""
    if hasattr(enc, "projection"):
        return x @ enc.projection, x.abs() @ enc.projection.abs()
    xc = x - enc.mean
    return (xc @ enc.w @ enc.r,
            (xc.abs() @ enc.w.abs()) @ enc.r.abs())


def code_bits(torch, c):
    """``int32[n, W]`` codes -> ``bool[n, 32W]``, bit j of word w at 32w+j."""
    shifts = torch.arange(32, dtype=torch.int32, device=c.device)
    return (((c[..., None] >> shifts) & 1) != 0).reshape(c.shape[0], -1)


def encoder_phase(torch, kb, kp, dev, k10, smi, n=N_MAIN, dim=128,
                  sample=20_000, n_check=4096, nq=Q):
    """Phase 14: the encoders on the card, then the engine on their codes.
    Returns the phase's blockmin launches."""
    from verticut_tpu_torch import bench
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.models import ITQEncoder, RandomProjectionLSH
    from verticut_tpu_torch.models.lsh import encode_corpus
    from verticut_tpu_torch.search import mih_search
    zero_counts(kb, kp)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    n_clusters = max(1, n // 100)
    centers = torch.randn((n_clusters, dim), generator=gen, device=dev)
    x = centers[torch.randint(0, n_clusters, (n,), generator=gen,
                              device=dev)]
    x += 0.5 * torch.randn((n, dim), generator=gen, device=dev)
    del centers
    t0 = time.perf_counter()
    itq = ITQEncoder.fit(x[:sample], 128, 50, 0)
    bench.sync(dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lsh = RandomProjectionLSH.create(dim, 128, 0, device=dev)
    bench.sync(dev)
    create_s = time.perf_counter() - t0
    out = {}
    for name, enc in (("ITQ", itq), ("LSH", lsh)):
        encode_corpus(enc, x[:65536])                  # warm-up
        bench.sync(dev)
        t0 = time.perf_counter()
        c = encode_corpus(enc, x)
        bench.sync(dev)
        enc_s = time.perf_counter() - t0
        cpu_enc = type(enc)(*(a.cpu() for a in enc))
        xs = x[:n_check].cpu()
        differ = code_bits(torch, c[:n_check].cpu() ^ cpu_enc.encode(xs))
        z, scale = near_zero_bits(torch, cpu_enc, xs)
        near_abs, near_rel = z.abs() <= 1e-5, z.abs() <= 1e-5 * scale
        check(not bool((differ & ~near_rel).any()),
              f"encoder {name}: the card's codes differ from the CPU's at "
              f"{int((differ & ~near_rel).sum())} bits away from 0")
        log(f"encoder {name} D={dim} bits=128: encode_corpus of {n} rows "
            f"on the card {enc_s:.4f} s ({n / enc_s:.0f} codes/s); on "
            f"{n_check} rows the card's codes equal the CPU encoder's but "
            f"for {int(differ.sum())} bits, all within rounding of 0 "
            f"({int(near_rel.sum())} bits within 1e-5 of the product's "
            f"absolute sum, {int(near_abs.sum())} within 1e-5 of 0); {smi}")
        out[name] = c
    log(f"encoder ITQ fit on {sample} rows, 50 iterations: {fit_s:.3f} s; "
        f"LSH create {create_s:.4f} s; {smi}")
    del x
    t0 = time.perf_counter()
    index = build_index(out["ITQ"], MIHConfig(bits=128, n_tables=4),
                        device=dev)
    bench.sync(dev)
    build_s = time.perf_counter() - t0
    q = bench.perturbed_queries(np.random.default_rng(14), index.codes, nq)
    res = mih_search(index, q, k10)
    res, batch_s = timed_on(torch, dev, lambda: mih_search(index, q, k10))
    check_result(torch, "ITQ codes k=10", res, index.codes, q, k10.knn)
    od, oi = oracle(q[:256], index.codes, k10.knn)
    ties = tie_equal(torch, "ITQ codes k=10 vs the oracle",
                     SimpleNamespace(dists=res.dists[:256],
                                     ids=res.ids[:256]), od, oi)
    log(f"encoder ITQ codes: build_index {build_s:.3f} s; k=10 batch of "
        f"{nq} perturbed rows {batch_s:.4f} s, radius histogram "
        f"{torch.bincount(res.radius).tolist()}; 256 rows equal the oracle "
        f"in dists, in ids below the kth distance ({ties} rows with other "
        f"ids at it); blockmin launches {kb.launches}; {smi}")
    return kb.launches


def timed_on(torch, dev, fn):
    """``fn()`` and its seconds, ending in a sync of ``dev``."""
    from verticut_tpu_torch.bench import sync
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def scan_tier_rows():
    """Count the query rows that the sharded engines send to their scan
    tier and linear fallback (``sharded._device_linear``, under both
    engines' names for it). Yields a dict whose ``rows``
    :func:`sharded_counts` reads and zeroes."""
    from verticut_tpu_torch.search import sharded, sharded_compact
    tier = {"rows": 0}
    lock = threading.Lock()
    scan = sharded._device_linear

    def counted(mesh, codes_loc, queries, *a):
        with lock:
            tier["rows"] += queries.shape[0]
        return scan(mesh, codes_loc, queries, *a)

    with patched((sharded, "_device_linear", counted),
                 (sharded_compact, "_device_linear", counted)):
        yield tier


def sharded_counts(kb, kp, name, seen, tier):
    """The sharded engines' scan tier and fallback run the block-min scan
    over each rank's real rows: every blockmin launch on the tensor-core
    instance, at least one wherever rows went to the tier, and no
    pairwise launch. Adds the counts read since the last zeroing (by
    instance, and the tier's rows; the fetch + score kernel's launches,
    which the inline engine's radius steps make) to ``seen`` and zeroes
    them."""
    from verticut_tpu_torch.kernels import fetch_score as kf
    by = dict(kb.launches_by_instance)
    seen["blockmin"] += kb.launches
    seen["pairwise"] += kp.launches
    seen["fetch_score"] += kf.launches
    seen["rows"] += tier["rows"]
    for k, v in by.items():
        seen["by_instance"][k] += v
    check(by["generic"] == 0 and kp.launches == 0,
          f"{name}: the sharded path launched blockmin {by} / pairwise "
          f"{kp.launches} times")
    check(kb.launches > 0 or tier["rows"] == 0,
          f"{name}: {tier['rows']} rows went to the scan tier and blockmin "
          f"launched no time")
    log(f"{name}: blockmin launches {by}, {tier['rows']} rows to the scan "
        f"tier and fallback, pairwise launches {kp.launches}, fetch_score "
        f"launches {kf.launches}")
    zero_sharded(kb, kp, tier)


def zero_sharded(kb, kp, tier):
    """Zero the kernels' launch counts and the scan tier's rows."""
    zero_counts(kb, kp)
    tier["rows"] = 0


def no_launches():
    return {"blockmin": 0, "pairwise": 0, "fetch_score": 0, "rows": 0,
            "by_instance": {"tensor": 0, "generic": 0}}


def add_launches(*seen):
    """The sum of :func:`no_launches` records."""
    out = no_launches()
    for s in seen:
        for k in ("blockmin", "pairwise", "fetch_score", "rows"):
            out[k] += s[k]
        for k, v in s["by_instance"].items():
            out["by_instance"][k] += v
    return out


def world_phase(torch, kb, kp, dev, mesh, packed, k10, smi, tier, nq=Q):
    """Phase 15: the inline sharded engine in a world of one. Returns the
    index, its queries and the kernels' launches counted on its paths."""
    from verticut_tpu_torch import bench, bits
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.search import mih_search
    from verticut_tpu_torch.search.sharded import (build_sharded_index,
                                                   sharded_mih_search)
    cfg = MIHConfig(bits=128, n_tables=4)
    db = bits.as_codes(packed, dev)
    seen = no_launches()
    zero_sharded(kb, kp, tier)
    sidx, build_s = timed_on(torch, dev,
                             lambda: build_sharded_index(db, cfg, mesh))
    sharded_counts(kb, kp, "sharded build", seen, tier)
    index = build_index(db, cfg, device=dev)
    q = bench.perturbed_queries(np.random.default_rng(0), db, nq)
    od, oi = oracle(q[:256], db, k10.knn)
    for fused in (True, False):
        scfg = dataclasses.replace(k10, fused=fused)
        name = f"sharded N={len(packed)} k=10 {'fused' if fused else 'loop'}"
        zero_sharded(kb, kp, tier)
        sharded_mih_search(sidx, q, scfg)                # warm-up
        times = []
        for _ in range(3):
            res, dt = timed_on(torch, dev,
                               lambda: sharded_mih_search(sidx, q, scfg))
            times.append(dt)
        sharded_counts(kb, kp, name, seen, tier)
        mih_search(index, q, scfg)
        want, one_s = timed_on(torch, dev,
                               lambda: mih_search(index, q, scfg))
        for f in ("dists", "radius", "n_probes", "n_nonempty", "n_cands"):
            check(torch.equal(getattr(res, f), getattr(want, f)),
                  f"{name}: {f} != mih_search's")
        ties = tie_equal(torch, f"{name} vs mih_search", res, want.dists,
                         want.ids)
        check(torch.equal(res.dists[:256], od)
              and torch.equal(res.ids[:256], oi),
              f"{name}: != the popcount oracle")
        check_result(torch, name, res, db, q, k10.knn)
        log(f"{name} (world of one): {min(times):.4f} s/batch (runs "
            f"{', '.join(f'{t:.4f}' for t in times)}), mih_search "
            f"{one_s:.4f} s; dists and the four stats equal mih_search's, "
            f"ids below the kth distance ({ties} rows with other ids at "
            f"it); 256 rows equal the oracle; radius histogram "
            f"{torch.bincount(res.radius).tolist()}; build "
            f"{build_s:.3f} s; {smi}")
    return sidx, q, seen


def near_pad_queries(dev, seed=15):
    """The zero code and codes with 1 to 8 set bits: nearer to a sharded
    build's all-zero pad rows than to any row of a clustered corpus."""
    from verticut_tpu_torch import bits, codes
    rng = np.random.default_rng(seed)
    b = np.zeros((9, 128), np.uint8)
    for i in range(1, 9):
        b[i, rng.choice(128, i, replace=False)] = 1
    return bits.as_codes(codes.pack_bytes(
        np.packbits(b, axis=1, bitorder="little")), dev)


def padded_phase(torch, kb, kp, dev, mesh, packed, k10, smi, tier):
    """Phase 15b: a corpus that both sharded builds pad in a world of one
    (phase 4's 1M codes and 37 uniform ones, N = 1,000,037: the inline
    build pads to a multiple of 200 rows, the compact one to one of 128)
    under the near-pad queries. sharded_linear_search on either index,
    sharded_mih_search fused and loop and sharded_compact_search must
    each equal the oracle on the unpadded corpus in dists and ids.
    Returns the kernels' launches counted on these paths."""
    from verticut_tpu_torch import bits, codes
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.search.sharded import (build_sharded_index,
                                                   sharded_linear_search,
                                                   sharded_mih_search)
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, sharded_compact_search)
    cfg = MIHConfig(bits=128, n_tables=4)
    db = torch.cat([bits.as_codes(packed, dev),
                    bits.as_codes(codes.random_codes(37, 37, 128), dev)])
    n, k = db.shape[0], k10.knn
    q = near_pad_queries(dev)
    od, oi = oracle(q, db, k)
    pad_d = codes.hamming_distance(q, torch.zeros_like(q)).cpu()
    check(bool((od[:, 0] > pad_d).all()),
          f"padded: the queries lie no nearer the pads ({pad_d.tolist()}) "
          f"than the corpus ({od[:, 0].tolist()})")
    sidx = build_sharded_index(db, cfg, mesh)
    cidx = build_sharded_compact(db, cfg, mesh)
    pads = (sidx.codes.shape[0] - n, cidx.codes.shape[0] - n)
    check(min(pads) > 0, f"padded: the builds pad {pads} rows")
    seen = no_launches()
    zero_sharded(kb, kp, tier)
    runs = (
        ("sharded_linear_search inline", lambda: sharded_linear_search(
            mesh, sidx.codes, q, k, n_total=n)),
        ("sharded_linear_search compact", lambda: sharded_linear_search(
            mesh, cidx.codes, q, k, n_total=n)),
        ("sharded_mih_search fused", lambda: sharded_mih_search(sidx, q, k10)),
        ("sharded_mih_search loop", lambda: sharded_mih_search(
            sidx, q, dataclasses.replace(k10, fused=False))),
        ("sharded_compact_search", lambda: sharded_compact_search(
            cidx, q, k10)),
    )
    for name, fn in runs:
        d, i = fn()[:2]
        check(torch.equal(d.cpu(), od) and torch.equal(i.cpu(), oi),
              f"padded N={n} {name}: != the oracle on the unpadded corpus")
    sharded_counts(kb, kp, f"padded N={n}", seen, tier)
    log(f"padded N={n} (world of one; inline pads {pads[0]} rows, compact "
        f"{pads[1]}), {len(q)} near-pad queries at k={k}: "
        f"{', '.join(name for name, _ in runs)} each equal to the oracle "
        f"on the unpadded corpus in dists and ids; {smi}")
    return seen


def compact_phase(torch, kb, kp, dev, mesh, k10, smi, packed, tier, n=N_SCALE,
                  nq=Q, n_tier=128):
    """Phase 16: the compact sharded engine at the reference's default
    corpus, the scan tier apart (the block-min tier beside the
    scan_popcount tier it replaced, both over the same rows in one call),
    and the save/load round trip at 1M. Returns the kernels' launches
    counted on its paths and the two tier times in ms."""
    import shutil
    import tempfile
    from verticut_tpu_torch import bench, bits, codes
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.ops.hamming import scan_popcount
    from verticut_tpu_torch.search.sharded import _device_linear
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, load_sharded_compact, save_sharded_compact,
        sharded_compact_search)
    cfg = MIHConfig(bits=128, n_tables=4)
    corpus = codes.clustered_codes_device(
        0, n, 128, n_clusters=max(1, n // 200), flip_p=0.02, device=dev)
    q = bench.perturbed_queries(np.random.default_rng(0), corpus, nq)
    seen = no_launches()
    zero_sharded(kb, kp, tier)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cidx, build_s = timed_on(torch, dev,
                             lambda: build_sharded_compact(corpus, cfg, mesh))
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda"
            else float("nan"))
    del corpus
    st = cidx.memory_stats()
    log(f"compact sharded build N={n} (world of one): {build_s:.3f} s, "
        f"peak device memory {peak:.2f} GiB (max_memory_allocated), pbits "
        f"{cidx.pbits}, cap_rows {cidx.cap_rows}; memory_stats {st}; {smi}")
    sharded_compact_search(cidx, q, k10)                 # warm-up
    times = []
    for _ in range(2):
        res, dt = timed_on(torch, dev,
                           lambda: sharded_compact_search(cidx, q, k10))
        times.append(dt)
    name = f"compact N={n} k=10"
    sharded_counts(kb, kp, name, seen, tier)
    check_result(torch, name, res, cidx.codes, q, k10.knn)
    # the scan tier apart, on the tier's 128-query shape: the block-min
    # tier as the engine runs it, and the scan_popcount tier it replaced
    # (its chunk), over the same real rows; both against the oracle
    n_loc = cidx.codes.shape[0]
    rows, qt = cidx.codes[:cidx.n], q[:n_tier]
    od, oi = oracle(qt, rows, k10.knn)
    _device_linear(mesh, cidx.codes, qt, k10.knn, n_loc, cidx.n)
    bm_s = []
    for _ in range(3):
        (sd, si), dt = timed_on(torch, dev, lambda: _device_linear(
            mesh, cidx.codes, qt, k10.knn, n_loc, cidx.n))
        bm_s.append(dt)
    (pd, pi), pop_s = timed_on(torch, dev, lambda: scan_popcount(
        qt, rows, k10.knn, chunk=min(65536, n_loc)))
    for tier_name, d, i in (("block-min", sd, si), ("scan_popcount", pd, pi)):
        check(torch.equal(d.cpu(), od) and torch.equal(i.cpu(), oi),
              f"{name}: the {tier_name} scan tier != the oracle")
    zero_sharded(kb, kp, tier)
    ties = tie_equal(torch, f"{name} vs the oracle",
                     SimpleNamespace(dists=res.dists[:n_tier],
                                     ids=res.ids[:n_tier]), od, oi)
    bound, by = blockmin_bound(n_tier, cidx.n, cidx.n, 4, 512)
    log(f"{name} (compact sharded), {nq} clustered queries: "
        f"{min(times):.4f} s/batch (runs {', '.join(f'{t:.4f}' for t in times)}"
        f"); radius histogram {torch.bincount(res.radius).tolist()}; "
        f"{seen['rows']} rows to the scan tier, blockmin launches "
        f"{seen['by_instance']}; {n_tier} rows equal the oracle in dists, "
        f"in ids below the kth distance ({ties} rows with other ids at "
        f"it); the scan tier alone, {n_tier} queries over {cidx.n} codes: "
        f"block-min {min(bm_s):.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in bm_s)}; its blockmin pass alone "
        f"is bound by {bound:.4f} ms of {by}), scan_popcount (the tier "
        f"before) {pop_s:.4f} s, both equal to the oracle; {smi}")
    tier_ms = {"blockmin": min(bm_s) * 1e3, "popcount": pop_s * 1e3,
               "bound": bound, "batch_s": min(times)}
    del cidx, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the save/load round trip at 1M
    db = bits.as_codes(packed, dev)
    small = build_sharded_compact(db, cfg, mesh)
    tmp = tempfile.mkdtemp(prefix="vt_compact_")
    try:
        _, save_s = timed_on(torch, dev,
                             lambda: save_sharded_compact(tmp, small))
        back, load_s = timed_on(torch, dev,
                                lambda: load_sharded_compact(tmp, mesh))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(torch.equal(getattr(back, a), getattr(small, a))
              for a in ("idrows", "se", "codes")) and back.n == small.n,
          "compact save/load: the arrays changed")
    q1 = bench.perturbed_queries(np.random.default_rng(0), db, nq)
    a = sharded_compact_search(small, q1, k10)
    b = sharded_compact_search(back, q1, k10)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "compact save/load: the loaded index answers differently")
    od, oi = oracle(q1[:256], db, k10.knn)
    ties1 = tie_equal(torch, "compact 1M vs the oracle",
                      SimpleNamespace(dists=a.dists[:256], ids=a.ids[:256]),
                      od, oi)
    sharded_counts(kb, kp, "compact save/load", seen, tier)
    log(f"compact sharded save/load N={len(packed)}: save {save_s:.3f} s, "
        f"load {load_s:.3f} s, arrays and every answer equal; 256 rows "
        f"equal the oracle (dists; ids below the kth distance, {ties1} rows "
        f"with other ids at it)")
    return seen, tier_ms


def sharded_service_phase(torch, kb, kp, sidx, smi, tier, n_req=400,
                          threads=16):
    """Phase 17: the server's sharded branch over TCP on localhost.
    Returns the kernels' launches counted under its load."""
    from verticut_tpu_torch.config import SearchConfig
    from verticut_tpu_torch.search.sharded import sharded_mih_search
    from verticut_tpu_torch.service import ImageSearchClient, ImageSearchServer
    from verticut_tpu_torch.tools.image_search_test import pcts, run_load
    k = 10
    srv = ImageSearchServer(sidx, port=0, default_knn=k, sharded=True).start()
    try:
        t0 = time.perf_counter()
        srv.prewarm(max_rows=128)
        prewarm_s = time.perf_counter() - t0
        cli = ImageSearchClient(port=srv.port, pool=threads, timeout=300)
        ids = np.random.default_rng(17).integers(0, sidx.n, n_req).tolist()
        run_load(cli, ids[:2 * threads], k, threads)
        zero_sharded(kb, kp, tier)
        dt, lats, served = run_load(cli, ids, k, threads)
        st = cli.stats()
        cli.close()
    finally:
        srv.stop()
    seen = no_launches()
    sharded_counts(kb, kp, "sharded service", seen, tier)
    qids = sorted(set(ids))
    q = sidx.codes[torch.tensor(qids, device=sidx.device)]
    want = sharded_mih_search(sidx, q, SearchConfig(knn=k))
    d, i = served_rows(torch, "sharded service", [served[x] for x in qids], k)
    ties = tie_equal(torch, "sharded service vs sharded_mih_search",
                     SimpleNamespace(dists=d, ids=i), want.dists, want.ids)
    log(f"sharded service (world of one) search_image_by_id k={k}, "
        f"{threads} client threads, {n_req} requests: {n_req / dt:.1f} QPS, "
        f"p50/p90/p99 {pcts(lats)} ms; prewarm {prewarm_s:.2f} s; "
        f"{st['n_requests']} rows in {st['n_batches']} batches; every answer "
        f"equal to sharded_mih_search in dists, in ids below the kth "
        f"distance ({ties} rows with other ids at it); {smi}")
    return seen


# --------------------------------------------------------------------------
# Phase 18: the command-line tools, each tool's main() called in process
# --------------------------------------------------------------------------

#: the fields of an accuracy row that hold no time
ACCURACY_FIELDS = ("distance_ratio", "inaccurate_count", "accuracy",
                   "mean_radius_exact", "mean_radius_approx")


def run_tool(tool, argv, head=12):
    """``tool.main(argv)`` in this process (so the kernels' counters see
    it), its stdout and stderr captured and logged (the first ``head``
    lines of stdout); returns ``(stdout, stderr, main's return value)``. A
    tool that exits non-zero raises SystemExit through here and ends the
    script."""
    import io
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        ret = tool.main(argv)
    name = tool.__name__.rsplit(".", 1)[-1]
    lines = [ln for ln in out.getvalue().splitlines()
             if not re.fullmatch(r"-?\d+ : \d+", ln)]
    log(f"  {name} {' '.join(argv)}: {time.perf_counter() - t0:.2f} s")
    for ln in lines[:head] + [ln for ln in err.getvalue().splitlines()
                            if not ln.startswith(("W1", "I1"))][:6]:
        log(f"    | {ln}")
    return out.getvalue(), err.getvalue(), ret


def tool_rows(torch, text, k):
    """A search tool's ``"id : dist"`` lines as host ``(dists, ids)``
    ``[Q, k]`` tensors."""
    pairs = [tuple(map(int, ln.split(" : "))) for ln in text.splitlines()
             if re.fullmatch(r"-?\d+ : \d+", ln)]
    t = torch.tensor(pairs, dtype=torch.int32).reshape(-1, k, 2)
    return t[..., 1].contiguous(), t[..., 0].contiguous()


def stat_line(err):
    return [ln for ln in err.splitlines() if ln.startswith("average")]


def npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in x.files)


def seconds(text, what):
    """The seconds a tool printed after ``what``."""
    m = re.search(re.escape(what) + r".*? in ([\d.]+)s", text)
    return float(m[1]) if m else float("nan")


def tools_phase(torch, kb, kp, dev, packed, smi):
    """Phase 18: every command-line tool of the port on the card, through
    its main(), on the bench corpus written to a code file. Returns the
    kernels' launches over the in-process tools."""
    import shutil
    import tempfile
    from verticut_tpu_torch import bits, codes
    from verticut_tpu_torch.config import MIHConfig, SearchConfig
    from verticut_tpu_torch.index import build_index, load_index, save_index
    from verticut_tpu_torch.models.lsh import write_code_file
    from verticut_tpu_torch.parallel import single_device_mesh
    from verticut_tpu_torch.parallel.world import close_world
    from verticut_tpu_torch.search import mih_search
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, load_sharded_compact)
    from verticut_tpu_torch.tools import (
        accuracy_sweep, bigann, build_index as t_build, generate_bitmap,
        integrity_check, linear_search as t_linear, search as t_search)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vt_tools_")
    try:
        zero_counts(kb, kp)
        code_file = os.path.join(tmp, "lsh.code")
        query_file = os.path.join(tmp, "queries.code")
        uq = codes.random_codes(18, 200, 128)
        write_code_file(code_file, packed)
        write_code_file(query_file, uq)
        db = bits.as_codes(packed, dev)
        src = ["--binary_file", code_file, "-i", str(N_MAIN)]

        # 1.-2. build_index three ways and --mesh 1x1x1, each against the
        # same build in memory
        builds = {"inline": ([], {}), "compact": (["--compact"],
                                                  {"store_codes": False}),
                  "bitmap": (["--bitmap", "--ntables", "8"],
                             {"with_bitmap": True})}
        paths = {}
        for name, (flags, kw) in builds.items():
            paths[name] = os.path.join(tmp, f"{name}.npz")
            out, _, _ = run_tool(t_build, src + ["--out", paths[name]] + flags)
            cfg = MIHConfig(bits=128, n_tables=8 if kw.get("with_bitmap")
                            else 4)
            mem = os.path.join(tmp, f"mem_{name}.npz")
            save_index(mem, build_index(db, cfg, **kw))
            check(npz_equal(paths[name], mem),
                  f"build_index {name}: the file differs from the build in "
                  "memory")
            log(f"tools build_index {name}: build "
                f"{seconds(out, 'tables over')} s, save "
                f"{seconds(out, 'saved to')} s; every array equal to the "
                f"build in memory")
        mesh_dir = os.path.join(tmp, "mesh")
        torch.cuda.empty_cache()
        out, _, _ = run_tool(t_build, src + ["--out", mesh_dir, "--mesh",
                                             "1x1x1"])
        mesh = single_device_mesh()
        try:
            back = load_sharded_compact(mesh_dir, mesh)
            mem = build_sharded_compact(db, MIHConfig(), mesh)
            check(back.n == mem.n and all(
                torch.equal(getattr(back, a), getattr(mem, a))
                for a in ("idrows", "se", "codes")),
                "build_index --mesh 1x1x1: the saved shards differ from "
                "the build in memory")
        finally:
            close_world()
        del back, mem
        log(f"tools build_index --mesh 1x1x1 (a spawned rank on the card): "
            f"build {seconds(out, 'devices')} s, save "
            f"{seconds(out, 'per-shard to')} s; arrays equal to the build "
            f"in memory")

        # 3. search, held to the popcount oracle
        inline = paths["inline"]
        out_q, err_q, _ = run_tool(t_search, ["--index", inline, "-q",
                                              "12345", "-k", "100"])
        d_q, i_q = tool_rows(torch, out_q, 100)
        od, oi = oracle(db[12345:12346], db, 100)
        ties = tie_equal(torch, "tools search -q 12345 -k 100",
                         SimpleNamespace(dists=d_q, ids=i_q), od, oi)
        out, _, _ = run_tool(t_search, ["--index", inline, "-f", query_file,
                                        "-k", "10"])
        d, i = tool_rows(torch, out, 10)
        uq_dev = bits.as_codes(uq, dev)
        od, oi = oracle(uq_dev, db, 10)
        ties += tie_equal(torch, "tools search -f -k 10",
                          SimpleNamespace(dists=d, ids=i), od, oi)
        out, _, _ = run_tool(t_search, ["--index", inline, "-f", query_file,
                                        "-k", "10", "-a"])
        d, i = tool_rows(torch, out, 10)
        check_result(torch, "tools search -f -k 10 -a",
                     SimpleNamespace(dists=d, ids=i), db, uq_dev, 10)
        want = mih_search(load_index(inline, device=dev), uq_dev,
                          SearchConfig(knn=10, approximate=True))
        check(torch.equal(d, want.dists) and torch.equal(i, want.ids),
              "tools search -a: not mih_search's approximate answer")
        recall = float((i[:, :, None] == oi[:, None, :]).any(-1).float()
                       .mean())
        torch.cuda.empty_cache()
        out_m, err_m, _ = run_tool(t_search, ["--index", inline, "-q",
                                              "12345", "-k", "100",
                                              "--mesh", "1x1x1"])
        d_m, i_m = tool_rows(torch, out_m, 100)
        check(torch.equal(d_m, d_q) and torch.equal(i_m, i_q),
              "tools search --mesh 1x1x1: not the single-device answer")
        check(stat_line(err_m) == stat_line(err_q) != [],
              f"tools search --mesh 1x1x1: stat line {stat_line(err_m)} "
              f"against {stat_line(err_q)}")
        log(f"tools search: -q 12345 -k 100, -f (200 uniform) -k 10 equal "
            f"the oracle in dists and in ids below the kth distance ({ties} "
            f"rows with other ids at it); -a equals mih_search's approximate "
            f"answer, every id at its distance, recall@10 {recall:.4f}; "
            f"--mesh 1x1x1 equals the single-device lines and stat line "
            f"{stat_line(err_q)[0]!r}")

        # 4. linear_search, both methods
        outs = {m: run_tool(t_linear, src + ["-q", "12345", "-k", "100",
                                             "--method", m])
                for m in ("popcount", "matmul")}
        check(outs["popcount"][0] == outs["matmul"][0],
              "tools linear_search: popcount and matmul differ")
        d_l, _ = tool_rows(torch, outs["popcount"][0], 100)
        check(torch.equal(d_l, d_q),
              "tools linear_search: dists differ from the search's")
        log(f"tools linear_search -q 12345 -k 100: popcount == matmul, "
            f"dists equal the search's; scan s "
            f"{ {m: seconds(o[1], 'scan of') for m, o in outs.items()} }")

        # 5. integrity_check: the inline file, a corrupted copy, and the
        # 100M row the reference tool was written for
        out, _, _ = run_tool(integrity_check, ["--index", inline])
        check(json.loads(out.splitlines()[0])["ok"],
              "tools integrity_check: the inline file is not ok")
        with np.load(inline) as z:
            arrs = dict(z)
        arrs["t0_ids"] = arrs["t0_ids"].copy()
        arrs["t0_ids"][5] ^= 1
        bad = os.path.join(tmp, "corrupt.npz")
        np.savez(bad, **arrs)
        del arrs
        try:
            run_tool(integrity_check, ["--index", bad])
            check(False, "tools integrity_check: a corrupted index passed")
        except SystemExit as e:
            check(e.code == 1, f"integrity_check exit {e.code}, not 1")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, _, _ = run_tool(integrity_check, ["--synthetic",
                                               str(N_SCALE)])
        peak = torch.cuda.max_memory_allocated() / 2**30
        rep = json.loads(out.splitlines()[0])
        check(rep["ok"] and rep["n"] == N_SCALE,
              f"tools integrity_check --synthetic {N_SCALE}: {rep}")
        gc.collect()
        torch.cuda.empty_cache()
        log(f"tools integrity_check: the inline file ok, the corrupted copy "
            f"exit 1; --synthetic {N_SCALE}: ok, build {rep['build_s']} s, "
            f"check {rep['check_s']} s, peak {peak:.2f} GiB "
            f"(max_memory_allocated); {smi}")

        # 6. generate_bitmap, byte-equal to the bitmaps of the index built
        # with --bitmap
        prefix = os.path.join(tmp, "bitmap")
        run_tool(generate_bitmap, src + ["--ntables", "8", "--out_prefix",
                                         prefix])
        bidx = load_index(paths["bitmap"], device=dev)
        for t, tab in enumerate(bidx.tables):
            with open(f"{prefix}.{t}", "rb") as f:
                check(f.read() == bits.to_u32(tab.bitmap.words).tobytes(),
                      f"tools generate_bitmap: table {t}'s file differs")
        del bidx
        log("tools generate_bitmap --ntables 8: 8 files byte-equal to the "
            "index's bitmaps")

        # 7. the accuracy protocol at 1M x 256 (two subprocesses)
        _, _, art = run_tool(accuracy_sweep, [
            os.path.join(tmp, "accuracy.json"), str(N_MAIN), "256"])
        ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "ACCURACY_r05.json")
        with open(ref_path) as f:
            ref = json.load(f)
        differ = []
        for corpus in ("clustered", "uniform"):
            for got, want in zip(art[corpus], ref[corpus], strict=True):
                same = all(got[f] == want[f] for f in ACCURACY_FIELDS)
                log(f"tools accuracy {corpus} k={got['k']}: exact "
                    f"{got['exact_s']} s, approx {got['approx_s']} s; "
                    + ", ".join(f"{f} {got[f]}" for f in ACCURACY_FIELDS)
                    + ("" if same else f" (ACCURACY_r05.json: "
                       + ", ".join(f"{f} {want[f]}" for f in ACCURACY_FIELDS)
                       + ")"))
                if not same:
                    differ.append((corpus, got["k"]))
        check(not differ, f"tools accuracy_sweep: rows {differ} differ from "
              "ACCURACY_r05.json in a field that holds no time")

        # 8. bigann's synthetic pipeline at 1M
        _, _, ev = run_tool(bigann, [
            "--synth", str(N_MAIN), "--queries", "1000", "--k", "10",
            "--shortlists", "10,100,1000", "--json",
            os.path.join(tmp, "bigann.json")])
        for row in ev.rows:
            log(f"tools bigann N={N_MAIN} shortlist {row['shortlist']}: recall@1 "
                f"{row['recall_at_1']}, recall@10 {row['recall_at_10']}, "
                f"distance ratio {row['distance_ratio']}, search "
                f"{row['search_s']} s, {row['qps']} QPS; {smi}")
        res = ev.results[1000]
        od, oi = oracle(ev.queries[:64], ev.index.codes, 1000)
        ties = tie_equal(torch, "tools bigann shortlist 1000",
                         SimpleNamespace(dists=res.dists[:64],
                                         ids=res.ids[:64]), od, oi)
        log(f"tools bigann shortlist 1000: 64 rows equal the oracle in dists "
            f"and in ids below the kth distance ({ties} rows with other ids "
            f"at it)")
        del ev, res
        # the subprocesses of accuracy_sweep and of the --mesh runs count
        # in their own processes, not here
        launches = {"blockmin": kb.launches, "pairwise": kp.launches,
                    "by_instance": dict(kb.launches_by_instance)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"tools phase launches (in-process tools): {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    check(launches["blockmin"] > 0 and launches["by_instance"]["generic"]
          == 0, f"tools phase: blockmin launches {launches}, not on the "
          "tensor-core instance only")
    check(launches["pairwise"] == 0,
          f"tools phase: {launches['pairwise']} pairwise launches")
    return launches


# --------------------------------------------------------------------------
# Phase 19: the key-value store and the last five tools
# --------------------------------------------------------------------------

#: the streaming build's corpus: the 1M cell's
N_STREAM = N_MAIN


def stream_phase(torch, dev, packed, smi, n=N_STREAM):
    """Phase 19a: the reference's streaming build (``build_hash_tables.cc``)
    through ``BucketStore(DHTStore())``: every (table, substring) -> (id,
    code) of the first ``n`` codes appended in id order, then every
    bucket's records held against the card's ``build_index(...,
    directory="hash")``: the buckets, laid end to end in CSR order (each
    found by the directory's lookup), are the table's entry ids, and each
    record's code is its id's code."""
    from verticut_tpu_torch import bits, codes
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index import build_index
    from verticut_tpu_torch.kv import BucketStore, DHTStore

    cfg = MIHConfig(bits=128, n_tables=4)
    corpus = packed[:n]
    subs = codes.all_substrings(bits.as_codes(corpus), cfg.n_tables)
    subs = subs.numpy().view(np.uint32)
    raw = codes.unpack_to_bytes(corpus)
    rows = [r.tobytes() for r in raw]
    sub_rows = subs.tolist()
    bs = BucketStore(DHTStore(), code_bytes=cfg.bits // 8)
    t0 = time.perf_counter()
    for i, (rec, keys) in enumerate(zip(rows, sub_rows)):
        for t, key in enumerate(keys):
            bs.append(t, key, i, rec)
    stream_s = time.perf_counter() - t0
    stats = bs.store.stats()
    n_app = n * cfg.n_tables
    log(f"streaming build N={n}: {n_app} appends in {stream_s:.2f} s, "
        f"{n_app / stream_s:.0f} appends/s (host, one thread); DHT "
        f"{len(bs.store)} keys, stats {stats}; {smi}")
    check(stats["crc_failures"] == 0, f"streaming build: {stats}")

    t0 = time.perf_counter()
    index = build_index(corpus, cfg, directory="hash", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_buckets = 0
    for t in range(cfg.n_tables):
        tab = index.tables[t]
        keys = np.unique(subs[:, t])
        start, count = tab.directory.lookup(bits.as_codes(keys, dev))
        start, count = start.cpu().numpy(), count.cpu().numpy()
        order = np.argsort(start, kind="stable")
        start, count, keys = start[order], count[order], keys[order]
        check(bool((count > 0).all()) and int(count.sum()) == n
              and np.array_equal(start, np.cumsum(count) - count),
              f"streaming build table {t}: the directory's buckets do not "
              "tile the entry rows")
        # records (id u32 le, code) of every bucket, end to end
        got = np.frombuffer(b"".join(
            bs.store.get(bs.key(t, int(k))) for k in keys),
            np.uint8).reshape(n, 4 + cfg.bits // 8)
        eids = bits.to_u32(tab.entry_ids)
        check(np.array_equal(got[:, :4].copy().view("<u4")[:, 0], eids),
              f"streaming build table {t}: bucket ids differ from the CSR")
        check(np.array_equal(got[:, 4:], raw[eids]),
              f"streaming build table {t}: a record's code is not its id's")
        n_buckets += len(keys)
    check(len(bs.store) == n_buckets,
          f"streaming build: {len(bs.store)} keys, {n_buckets} buckets")
    log(f"streaming build == card build_index(directory='hash') in all "
        f"{n_buckets} buckets of {cfg.n_tables} tables (ids in CSR order, "
        f"codes); card build {build_s:.3f} s, check "
        f"{time.perf_counter() - t0:.1f} s")
    bs.store.close()
    return {"n": n, "appends_per_s": n_app / stream_s, "stream_s": stream_s,
            "build_s": build_s, "stats": stats}


def kv_tools_phase(torch, kb, kp, dev, smi):
    """Phase 19b-f: kv_loadtest, perf_sweep search, collective_bench,
    multiproc_demo and tcp_echo through their main(). Returns the
    kernels' launches of perf_sweep's searches."""
    import shutil
    import tempfile
    from verticut_tpu_torch import bits, search
    from verticut_tpu_torch.search import single
    from verticut_tpu_torch.tools import (collective_bench, kv_loadtest,
                                          multiproc_demo, perf_sweep,
                                          tcp_echo)

    # (b) the store under load, in both read modes, one store and four
    for mode in ("direct", "server"):
        for shards in ("1", "4"):
            out, _, _ = run_tool(kv_loadtest, [
                "--backend", "dht", "-n", "100000", "--read_mode", mode,
                "--n_shards", shards])
            rec = json.loads(out.splitlines()[-1])
            check(rec["ops"] == 100000 and rec["p50_us"] > 0,
                  f"kv_loadtest {mode} x{shards}: {rec}")
            stats = [ln for ln in out.splitlines() if ln.startswith("stats:")]
            check(bool(stats) == (mode == "direct" and shards == "1"),
                  f"kv_loadtest {mode} x{shards}: stats lines {stats}")
            check(all("'crc_failures': 0" in ln for ln in stats),
                  f"kv_loadtest: {stats}")
    log(f"kv_loadtest: {smi}")

    # (c) perf_sweep search at 1M on the card, every answer held to the
    # oracle on its first 64 queries
    seen = {}

    def recorded(index, queries, scfg, *a):
        res = single.mih_search(index, queries, scfg, *a)
        seen[queries.shape[0], scfg.knn] = (index, queries, res)
        return res

    zero_counts(kb, kp)
    with patched((search, "mih_search", recorded)):
        out, _, _ = run_tool(perf_sweep, [
            "search", "--n", str(N_MAIN), "--q", "512,8192", "--k", "10,100",
            "--repeats", "3"])
    launches = {"blockmin": kb.launches,
                "by_instance": dict(kb.launches_by_instance),
                "pairwise": kp.launches}
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check([r["cell"] for r in rows] == [
        {"n": N_MAIN, "q": q, "k": k} for q in (512, 8192) for k in (10, 100)],
        f"perf_sweep rows {rows}")
    check(sorted(seen) == [(512, 10), (512, 100), (8192, 10), (8192, 100)],
          f"perf_sweep searched {sorted(seen)}")
    for (nq, k), (index, queries, res) in sorted(seen.items()):
        q = bits.as_codes(queries[:64], dev)
        od, oi = oracle(q, index.codes, k)
        check(torch.equal(res.dists[:64], od) and torch.equal(res.ids[:64],
                                                              oi),
              f"perf_sweep q={nq} k={k}: not the oracle's answer")
    for r in rows:
        log(f"perf_sweep N={N_MAIN} q={r['cell']['q']} k={r['cell']['k']}: "
            f"QPS min {r['qps']['min']} avg {r['qps']['avg']} max "
            f"{r['qps']['max']} (3 runs); oracle-equal on 64 queries")
    log(f"perf_sweep launches: {launches}; {smi}")
    # the sweep's queries are corpus rows: few or no stragglers reach the
    # scan tier, but whatever blockmin launches must be tensor-core
    check(launches["by_instance"]["generic"] == 0,
          f"perf_sweep: blockmin launches {launches}, not on the "
          "tensor-core instance only")
    check(launches["pairwise"] == 0,
          f"perf_sweep: {launches['pairwise']} pairwise launches")
    seen.clear()

    # (d) the gather sweep on the card's memory and an all_gather in a
    # world of one on NCCL
    out, _, _ = run_tool(collective_bench, ["--max_pow", "17", "--mesh",
                                            "1x1x1"], head=20)
    kinds = [ln.split()[0] for ln in out.splitlines()[1:]]
    check(kinds == ["gather"] * 6 + ["all_gather"] * 6,
          f"collective_bench lines {kinds}")
    log(f"collective_bench: {smi}")

    # (e) the multi-process demo in a world of one on the card
    tmp = tempfile.mkdtemp(prefix="vt_multiproc_")
    try:
        _, _, art = run_tool(multiproc_demo, [
            "--mesh", "1x1x1", "--out", os.path.join(tmp, "MULTIPROC.json")])
        check(art["ok"] and art["oracle_multiset_equal"]
              and art["id_dist_equal"] and art["save_load_roundtrip_equal"],
              f"multiproc_demo: {art}")
        check(art["n_processes"] == 1 and art["platform"].startswith("cuda")
              and "nccl" in art["platform"], f"multiproc_demo: {art}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"multiproc_demo 1x1x1: build {art['build_s']} s, search "
        f"{art['search_s']} s, total {art['total_s']} s; {smi}")

    # (f) the TCP echo control
    out, _, _ = run_tool(tcp_echo, [], head=20)
    sizes = [json.loads(ln)["size"] for ln in out.splitlines()]
    check(sizes == [1 << i for i in range(13)], f"tcp_echo sizes {sizes}")
    log(f"tcp_echo: {smi}")
    return launches


# --------------------------------------------------------------------------
# Phase 20: the profiling and measurement tools
# --------------------------------------------------------------------------

#: the scan tools' corpus (the JAX tools' default) and the mesh tools'
N_PROFILE_SCAN = 16_000_000
N_PROFILE_MESH = 20_000_000
#: where phase 20 keeps every tool's whole JSON record and artifact (a
#: temporary directory, removed at the end, when unset)
PROFILE_OUT = os.environ.get("VERTICUT_PROFILE_OUT")


def _profile_runs(torch, runs, out, recs, seconds, smi):
    """Phase 20's tools one after another: each main() in this process,
    its checks held, its record logged and written to ``out``."""
    for tool, argv in runs:
        name = tool.__name__.rsplit(".", 1)[-1]
        t0 = time.perf_counter()
        _, _, rec = run_tool(tool, argv, head=0)
        seconds[name] = time.perf_counter() - t0
        check(isinstance(rec, dict), f"{name}: no record")
        bad = [c for c, v in rec.get("checks", {}).items() if not v]
        check(not bad, f"{name}: checks failed {bad}")
        for key in ("ok", "distances_equal", "ids_equal",
                    "oracle_multiset_equal", "load_multiset_equal"):
            check(rec.get(key, True) is True, f"{name}: {key} {rec.get(key)}")
        recs[name] = rec
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(rec, f)
        short = {k: v for k, v in rec.items() if k != "profile"}
        log(f"  {name}: {json.dumps(short)[:1500]}; {smi}")
        # each tool from a clean allocator, as in a process of its own
        gc.collect()
        torch.cuda.empty_cache()


def profile_tools_phase(torch, kb, kp, dev, smi):
    """Phase 20: every profiling tool of the port through its main(), at
    the JAX tools' sizes but for the mesh tools' 20M (phase 16 runs the
    compact layout at 100M); each tool's checks must hold (a failing check
    exits the tool non-zero, which ends the script). Every record is logged
    beside the card's name and power limit and written whole to
    ``$VERTICUT_PROFILE_OUT/<tool>.json`` when that is set. Returns the
    kernels' launches of the in-process tools and the records."""
    import shutil
    import tempfile
    from verticut_tpu_torch.tools import (
        compact_chip_bench, gather_bench, int8_scan_bench, microbench_r5,
        pipeline_overlap_bench, profile_fused_ablate, profile_scan,
        profile_stages, profile_stages2, profile_tiers, qscale_bench,
        virtual_scale_run)
    out = PROFILE_OUT or tempfile.mkdtemp(prefix="vt_profile_")
    os.makedirs(out, exist_ok=True)
    n = str(N_MAIN)
    runs = (
        (profile_stages2, ["--n", n]),
        (profile_stages, ["--n", n]),
        (profile_tiers, ["--n", n]),
        (profile_fused_ablate, ["--n", n, "--r", "4"]),
        (qscale_bench, ["--n", n, "--batches", "6"]),
        (pipeline_overlap_bench, ["--n", n]),
        (profile_scan, [str(N_PROFILE_SCAN)]),
        (int8_scan_bench, [str(N_PROFILE_SCAN)]),
        (gather_bench, []),
        (microbench_r5, []),
        (compact_chip_bench, [str(N_PROFILE_MESH), os.path.join(
            out, "BENCH_COMPACT_torch.json")]),
        (virtual_scale_run, [str(N_PROFILE_MESH), os.path.join(
            out, "VIRTUAL_SCALE_torch.json"), "--mesh", "1x1x1"]),
    )
    t_phase = time.perf_counter()
    zero_counts(kb, kp)
    recs, seconds = {}, {}
    try:
        _profile_runs(torch, runs, out, recs, seconds, smi)
    finally:
        if not PROFILE_OUT:
            shutil.rmtree(out, ignore_errors=True)
    check(recs["virtual_scale_run"]["backend"].startswith("cuda"),
          f"virtual_scale_run: {recs['virtual_scale_run']['backend']}")
    launches = {"blockmin": kb.launches, "pairwise": kp.launches,
                "by_instance": dict(kb.launches_by_instance)}
    log(f"phase 20 launches (in-process tools): {launches}; seconds by "
        f"tool {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    # profile_scan and int8_scan_bench run both instances; the scan tiers
    # of the fused tools the tensor-core one
    check(all(v > 0 for v in launches["by_instance"].values()),
          f"phase 20: blockmin launches {launches}")
    check(launches["pairwise"] == 0,
          f"phase 20: {launches['pairwise']} pairwise launches")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, recs


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
    from verticut_tpu_torch.kernels import fetch_score as kf
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
    with ThreadPoolExecutor(len((kb, kp, kf))) as pool:
        for f in [pool.submit(m.build) for m in (kb, kp, kf)]:
            f.result()
    log(f"kernels built for sm_90a in {time.perf_counter() - t0:.2f} s")
    for m in (kb, kp, kf):
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
    fs = fetch_score_phase(torch, kf, dev)
    max_err["fetch_score"] = max(r[0] for r in fs.values())

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
    with counted_steps() as steps:
        run_cell(torch, "1M k=10", index, q_dev, k10, 256, kb)
        run_cell(torch, "1M k=100", index, q_dev, k100, 256, kb)
        uniform, _ = run_cell(torch, "1M uniform k=10", index, u_dev, k10,
                              256, kb)
    main_launches = kb.launches
    main_by_instance = dict(kb.launches_by_instance)
    main_fetch = kf.launches
    log(f"main path blockmin launches by instance: {main_by_instance}; "
        f"fetch_score launches {main_fetch} in {steps['steps']} radius "
        f"steps of {cfg.n_tables} tables")
    check(main_fetch > 0 and main_fetch == cfg.n_tables * steps["steps"],
          f"the main path launched fetch_score {main_fetch} times in "
          f"{steps['steps']} radius steps")
    check(uniform > 0, "the uniform cell launched no blockmin kernel")
    check(main_by_instance["tensor"] > 0,
          "the main path launched no tensor-core blockmin kernel")

    # 5.-8. the linear-scan methods, the loop driver, approximate mode,
    # dispatch / finalize
    linear = linear_phase(torch, kb, kp, index.codes, u_dev)
    loop_phase(torch, kb, index, q_dev, u_dev, k10)
    approx_phase(torch, kb, index, q_dev, k10)
    dispatch_phase(torch, index, q_dev, k10)
    del u_dev, db          # the 1M index stays for the service phase
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
    scale_launches, scale_by_instance, index_100m = scale_phase(
        torch, kb, dev, k10, k100)
    scale_fetch = kf.launches
    log(f"100M phase blockmin launches by instance: {scale_by_instance}; "
        f"fetch_score launches {scale_fetch}")
    check(scale_fetch > 0, "the 100M phase launched no fetch_score kernel")
    check(scale_by_instance["tensor"] > 0,
          "the 100M phase launched no tensor-core blockmin kernel")

    # 11b. the service on the 1M and 100M indexes (counts zeroed inside,
    # after each prewarm)
    # 64 sockets: a thread per socket; 20, the client's default, as the
    # load generator runs it
    service_by_instance = service_phase(
        torch, kb, kp,
        (("1M", index, ((0, 64, 64), (16, 400, 64), (64, 400, 64),
                        (64, 400, 20))),
         ("100M", index_100m, ((16, 256, 64), (64, 256, 64)))), smi)
    log(f"service phase blockmin launches by instance: "
        f"{service_by_instance}")
    del index, index_100m
    gc.collect()           # a server and its socket server hold each other
    torch.cuda.empty_cache()
    log(f"after the service phase: {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated")

    # 12. the bucket directories (counts zeroed inside)
    bucket_by_instance = bucket_phase(torch, kb, kp, dev, packed, q_dev, k10)
    log(f"bucket phase blockmin launches by instance: {bucket_by_instance}")
    check(bucket_by_instance["generic"] == 0,
          "the bucket phase launched the generic blockmin instance")
    del q_dev
    torch.cuda.empty_cache()

    # 13. 1B codes (counts zeroed inside)
    billion_by_instance = billion_phase(torch, kb, kp, dev, k10)
    billion_fetch = kf.launches
    log(f"1B phase fetch_score launches (compact layout) {billion_fetch}")
    check(billion_fetch > 0, "the 1B phase launched no fetch_score kernel")
    gc.collect()
    torch.cuda.empty_cache()

    # 14. the encoders (counts zeroed inside)
    encoder_launches = encoder_phase(torch, kb, kp, dev, k10, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 15.-17. the sharded engines and server in a world of one on NCCL
    import torch.distributed as dist
    from verticut_tpu_torch.parallel import single_device_mesh
    from verticut_tpu_torch.parallel.world import close_world
    mesh = single_device_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"the world runs {dist.get_backend()} over "
          f"{dist.get_world_size()} ranks, not NCCL over one")
    log(f"world of one: backend {dist.get_backend()}, device {mesh.device}")
    with scan_tier_rows() as tier:
        sidx, _, world_seen = world_phase(torch, kb, kp, dev, mesh, packed,
                                          k10, smi, tier)
        padded_seen = padded_phase(torch, kb, kp, dev, mesh, packed, k10, smi,
                                   tier)
        service_seen = sharded_service_phase(torch, kb, kp, sidx, smi, tier)
        del sidx
        gc.collect()
        torch.cuda.empty_cache()
        compact_seen, tier_ms = compact_phase(torch, kb, kp, dev, mesh, k10,
                                              smi, packed, tier)
    close_world()
    sharded_launches = add_launches(world_seen, padded_seen, service_seen,
                                    compact_seen)
    log(f"phases 15-17 launches: {sharded_launches}")
    check(world_seen["fetch_score"] > 0,
          "the inline sharded engine launched no fetch_score kernel")
    check(sharded_launches["by_instance"]["tensor"] > 0,
          "phases 15-17 launched no tensor-core blockmin kernel")
    gc.collect()
    torch.cuda.empty_cache()

    # 18. the command-line tools (counts zeroed inside)
    tools_launches = tools_phase(torch, kb, kp, dev, packed, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 19. the key-value store and the last five tools (counts zeroed
    # inside, before perf_sweep)
    t0 = time.perf_counter()
    stream = stream_phase(torch, dev, packed, smi)
    kv_launches = kv_tools_phase(torch, kb, kp, dev, smi)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s (the stream "
        f"{stream['stream_s']:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()

    # 20. the profiling and measurement tools (counts zeroed inside)
    profile_launches, _ = profile_tools_phase(torch, kb, kp, dev, smi)

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
         "service_launches_by_instance": service_by_instance,
         "launches_1b": sum(billion_by_instance.values()),
         "launches_1b_by_instance": billion_by_instance,
         "encoder_phase_launches": encoder_launches,
         "sharded_launches": sharded_launches["blockmin"],
         "sharded_launches_by_instance": sharded_launches["by_instance"],
         "sharded_scan_tier_rows": sharded_launches["rows"],
         "sharded_100m_scan_tier_ms": tier_ms["blockmin"],
         "sharded_100m_popcount_tier_ms": tier_ms["popcount"],
         "sharded_100m_tier_blockmin_bound_ms": tier_ms["bound"],
         "sharded_100m_batch_s": tier_ms["batch_s"],
         "tools_phase_launches": tools_launches["blockmin"],
         "tools_phase_launches_by_instance": tools_launches["by_instance"],
         "perf_sweep_launches": kv_launches["blockmin"],
         "perf_sweep_launches_by_instance": kv_launches["by_instance"],
         "profile_phase_launches": profile_launches["blockmin"],
         "profile_phase_launches_by_instance":
             profile_launches["by_instance"],
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
         "sharded_launches": sharded_launches["pairwise"],
         "tools_phase_launches": tools_launches["pairwise"],
         "perf_sweep_launches": kv_launches["pairwise"],
         "profile_phase_launches": profile_launches["pairwise"],
         "ms": pw[1], "plain_ms": pw[2],
         "bound_ms": pairwise_bound(Q, N_PAIRWISE, 4), "bound_by": "bytes",
         "bound_what": "device-memory stores", "library_ms": pw_lib,
         "shape": f"Q={Q} N={N_PAIRWISE} W=4",
         "generic_ms": gen_pw[1], "generic_plain_ms": gen_pw[2],
         "generic_shape": f"Q={Q} N={N_PAIRWISE} W=2"},
        {"name": "fetch_score", "route": "cuda",
         "source": "verticut_tpu_torch/csrc/fetch_score.cu",
         "replaces": None, "launches": main_fetch,
         "scale_launches": scale_fetch, "launches_1b": billion_fetch,
         "sharded_launches": sharded_launches["fetch_score"],
         "max_abs_err": max_err["fetch_score"],
         "ms": fs["inline"][1], "plain_ms": fs["inline"][2],
         "bound_ms": fs["inline"][3], "bound_by": "bytes",
         "bound_what": "device-memory reads and writes", "library_ms": None,
         "shape": fs["inline"][4], "compact_ms": fs["compact"][1],
         "compact_plain_ms": fs["compact"][2],
         "compact_bound_ms": fs["compact"][3],
         "compact_shape": fs["compact"][4]}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
