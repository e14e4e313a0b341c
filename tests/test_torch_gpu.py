"""Tests of verticut_tpu_torch that need an NVIDIA GPU: the CUDA blockmin,
pairwise and fetch + score kernels against their plain twins (blockmin
also inside the folded block-min scan), and the search paths on the card
(fused and loop driver, range and bucket engines, every linear_search
method) against the popcount oracle. Exact equality throughout. They
skip without CUDA.

This file imports neither jax nor verticut_tpu, so on a machine without
JAX it runs apart from tests/conftest.py:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import json
import threading

import numpy as np
import pytest
import torch

import fetch_score_cases
from verticut_tpu_torch import bits, codes
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.kernels import fetch_score as kf
from verticut_tpu_torch.kernels import pairwise as kp
from verticut_tpu_torch.search import (linear_search, mih_search,
                                       mih_search_dispatch,
                                       mih_search_finalize, single)
from verticut_tpu_torch.search.linear import METHODS
from verticut_tpu_torch.utils import timer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _codes(rng, n, w):
    return bits.as_codes(rng.integers(0, 1 << 32, (n, w), dtype=np.uint32))


TENSOR_BLOCKS = (32, 64, 128, 256, 512, 1024, 2048)


def _check_blockmin(q, db, n, block, want_instance):
    before = (kb.launches, kb.launches_by_instance[want_instance])
    got = kb.blockmin(q, db, n, block)
    torch.cuda.synchronize()
    assert (kb.launches, kb.launches_by_instance[want_instance]) == (
        before[0] + 1, before[1] + 1)
    want = kb.blockmin_reference(q, db, n, block)
    assert int((got - want).abs().max()) == 0
    return got


@pytest.mark.parametrize("nq,n_rows,n", [(70, 5000, 4711), (129, 40000, 39999),
                                         (300, 1000, 0), (8192, 100000, 99999)])
def test_kernel_matches_twin(cuda_device, nq, n_rows, n):
    """The tensor-core instance at each of its blocks, 128-bit codes."""
    rng = np.random.default_rng(nq)
    q, db = _codes(rng, nq, 4), _codes(rng, n_rows, 4)
    db[5] = q[0]
    q, db = q.to(cuda_device), db.to(cuda_device)
    for block in TENSOR_BLOCKS:
        assert kb.instance(4, block) == "tensor"
        _check_blockmin(q, db, n, block, "tensor")


@pytest.mark.parametrize("w", range(1, 9))
@pytest.mark.parametrize("block", [32, 64, 128, 512, 1024, 2048])
def test_tensor_instance_matches_twin(cuda_device, w, block):
    """Every template instance of the tensor-core kernel (W = 1..8 by
    tile share 32, 64 and 128 rows), exact (max abs err 0) at Q in {1, 63,
    64, 129, 687}: partial query tiles and warpgroups; n < n_rows, n off
    the block grid, and an all-masked last block (rows past n only); a code
    equal to a query in the straddling block, another past n."""
    rng = np.random.default_rng(w * 10_000 + block)
    n_rows = 2 * 2048 + 3 * block + 77
    n = n_rows - block - 40                     # last block all past n
    q_all, db = _codes(rng, 687, w), _codes(rng, n_rows, w)
    db[n - 1] = q_all[0]
    db[n] = q_all[1]                            # past n: excluded
    q_all, db = q_all.to(cuda_device), db.to(cuda_device)
    for nq in (1, 63, 64, 129, 687):
        got = _check_blockmin(q_all[:nq].contiguous(), db, n, block, "tensor")
        assert int(got[0, (n - 1) // block]) == 0
        assert (got[:, -1] == 32 * w + 1).all()


def test_tensor_instance_extremes(cuda_device):
    """All-zero and all-ones codes and queries: dot = +-32W, distances 0
    and 32W; a one-row corpus; Q = 8192."""
    for w in (1, 2, 4, 8):
        zeros = torch.zeros((3000, w), dtype=torch.int32, device=cuda_device)
        ones = torch.full_like(zeros, -1)
        db = torch.cat([zeros[:1500], ones[:1500]])
        q = torch.cat([zeros[:65], ones[:65]])
        for block in (32, 512):
            got = _check_blockmin(q, db, 3000, block, "tensor")
            assert set(got.unique().tolist()) == {0, 32 * w}
        got = _check_blockmin(q, ones, 1, 128, "tensor")
        assert got[:65, 0].eq(32 * w).all() and got[65:, 0].eq(0).all()
        assert got[:, 1:].eq(32 * w + 1).all()
    rng = np.random.default_rng(8192)
    q, db = _codes(rng, 8192, 4), _codes(rng, 70_000, 4)
    q, db = q.to(cuda_device), db.to(cuda_device)
    for block in (128, 512):
        _check_blockmin(q, db, 69_999, block, "tensor")


def test_main_path_shapes_take_the_tensor_instance(cuda_device):
    """The search paths' shapes (W = 4, blocks 512 and 128; the 64-bit
    cell's W = 2) launch the tensor-core instance, and the C entry refuses
    it for a shape it does not take."""
    rng = np.random.default_rng(4)
    for w, block in ((4, 512), (4, 128), (2, 512), (2, 128)):
        q, db = _codes(rng, 300, w), _codes(rng, 20_000, w)
        _check_blockmin(q.to(cuda_device), db.to(cuda_device), 19_999, block,
                        "tensor")
    q, db = _codes(rng, 3, 9).to(cuda_device), _codes(rng, 100, 9).to(
        cuda_device)
    out = torch.empty((3, 1), dtype=torch.int32, device=cuda_device)
    err = kb._load().vt_blockmin(q.data_ptr(), db.data_ptr(), out.data_ptr(),
                                 3, 100, 100, 9, 128, 1,
                                 torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8, 9])
@pytest.mark.parametrize("block", [1, 16, 96, 4096])
def test_generic_blockmin_matches_twin(cuda_device, w, block):
    """Every code width and block the tensor-core instance does not take:
    the generic instance, with a straddling last block and rows past n."""
    rng = np.random.default_rng(w * 10_000 + block)
    n_rows = 3 * max(block, 700) + 5
    n = n_rows - max(1, block // 3) - 2
    q, db = _codes(rng, 77, w), _codes(rng, n_rows, w)
    db[n - 1] = q[0]
    db[n] = q[1]                                # past n: excluded
    q, db = q.to(cuda_device), db.to(cuda_device)
    assert kb.instance(w, block) == "generic"
    got = _check_blockmin(q, db, n, block, "generic")
    assert int(got[0, (n - 1) // block]) == 0


@pytest.mark.parametrize("nq,n", [(1, 1), (70, 5001), (300, 1025),
                                  (1000, 131073)])
def test_pairwise_kernel_matches_twin(cuda_device, nq, n):
    """The fast instance (128-bit codes) at tile-edge shapes."""
    rng = np.random.default_rng(nq + n)
    q, db = _codes(rng, nq, 4), _codes(rng, n, 4)
    db[n // 2] = q[0]
    q, db = q.to(cuda_device), db.to(cuda_device)
    before = kp.launches
    got = kp.pairwise(q, db)
    torch.cuda.synchronize()
    assert kp.launches == before + 1
    assert torch.equal(got, kp.pairwise_reference(q, db))


@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_generic_pairwise_matches_twin(cuda_device, w):
    """Every code width but the fast instance's: the generic instance."""
    rng = np.random.default_rng(w)
    q, db = _codes(rng, 130, w), _codes(rng, 70_001, w)
    db[11] = q[3]
    q, db = q.to(cuda_device), db.to(cuda_device)
    before = kp.launches
    got = kp.pairwise(q, db)
    torch.cuda.synchronize()
    assert kp.launches == before + 1
    assert torch.equal(got, kp.pairwise_reference(q, db))


FETCH_TWINS = {"inline": (kf.fetch_score_blocks,
                          kf.fetch_score_blocks_reference),
               "compact": (kf.fetch_score_idrows,
                           kf.fetch_score_idrows_reference)}


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("layout,aligned", [("inline", True),
                                            ("compact", True),
                                            ("compact", False)])
def test_fetch_score_kernel_matches_twin(cuda_device, layout, w, aligned):
    """Both layouts' entries, W = 1-8 (blocks above 32 rows at W = 1 and
    2 inline), one launch each, bit-equal to the twin; ``aligned=False``
    moves the compact codes one word off their allocation, so the kernel
    takes its narrower loads."""
    case = fetch_score_cases.make(layout, w, seed=w, nq=300, chb=40, nb=400)
    t = case.tensors(cuda_device)
    if not aligned:
        spare = torch.empty(t[1].numel() + 1, dtype=torch.int32,
                            device=cuda_device)
        t[1] = spare[1:].view(t[1].shape).copy_(t[1])
    kernel, twin = FETCH_TWINS[layout]
    kw = {} if layout == "compact" else {"blk": case.blk}
    before = kf.launches
    got = kernel(*t, **kw)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    want = twin(*t, **kw)
    for g, x in zip(got, want, strict=True):
        assert torch.equal(g, x)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_mih_search_on_card_matches_oracle(cuda_device, uniform, fused):
    packed = codes.clustered_codes(2, 100_000, 128, n_clusters=500,
                                   flip_p=0.02)
    q = (codes.random_codes(9, 1024, 128) if uniform
         else packed[:1024] ^ np.uint32(5))
    index = build_index(packed, MIHConfig(), device=cuda_device)
    before = kb.launches
    res = mih_search(index, q, SearchConfig(knn=10, fused=fused))
    od, oi = linear_search(q, index.codes, 10, method="popcount")
    assert torch.equal(res.dists, od.cpu()) and torch.equal(res.ids, oi.cpu())
    if uniform:              # the scan tier or the fallback ran the kernel
        assert kb.launches > before


def test_scan_tier_on_card_runs_its_stragglers_rounded(cuda_device,
                                                       monkeypatch):
    """A 1M corpus of tight clusters and a batch of 1,000 one-bit
    near-duplicates with 300 uniform codes: the uniform rows are the
    stragglers, so the scan tier runs once, on their count rounded up to
    blockmin's query tile (the ladder's rung would be 512), and the
    answers equal the popcount oracle's."""
    packed = codes.clustered_codes(4, 1_000_000, 128, n_clusters=5000,
                                   flip_p=0.005)
    q = np.concatenate([packed[::1000] ^ np.uint32(1),
                        codes.random_codes(11, 300, 128)])
    index = build_index(packed, MIHConfig(), device=cuda_device)
    ran = []
    scan = single.scan_blockmin

    def counted(queries, *a, **kw):
        ran.append(queries.shape[0])
        return scan(queries, *a, **kw)

    monkeypatch.setattr(single, "scan_blockmin", counted)
    before = timer.counters()
    res = mih_search(index, q, SearchConfig(knn=10))
    c = timer.counters(since=before)
    od, oi = linear_search(q, index.codes, 10, method="popcount")
    assert torch.equal(res.dists, od.cpu()) and torch.equal(res.ids, oi.cpu())
    n_sc = c["mih.scan_rows"]
    assert 129 <= n_sc <= 1024
    rows = kb.QUERY_TILE * -(-n_sc // kb.QUERY_TILE)
    assert ran == [rows] and c["mih.scan_budget_rows"] == rows
    assert c.get("mih.fallback_rows", 0) == 0


@pytest.mark.parametrize("directory,m", [("auto", 8), ("sorted", 4),
                                         ("prefix", 4), ("hash", 4)])
@pytest.mark.parametrize("fused", [True, False])
def test_bucket_engines_on_card_match_oracle(cuda_device, directory, m,
                                             fused):
    """The bucket engines on the card (dense at 16-bit substrings with the
    bitmap; sorted, prefix and hash at 32 bits, codes crossing 2^31),
    equal to the popcount oracle in dists, and in ids below each row's
    kth distance."""
    packed = codes.clustered_codes(5, 100_000, 128, n_clusters=500,
                                   flip_p=0.02)
    packed[:5000] ^= np.uint32(0x80808080)
    index = build_index(packed, MIHConfig(bits=128, n_tables=m),
                        directory=directory, with_bitmap=m == 8,
                        device=cuda_device)
    assert not index.is_range
    q = np.concatenate([packed[:384] ^ np.uint32(0x10001),
                        codes.random_codes(10, 128, 128)])
    res = mih_search(index, q, SearchConfig(knn=10, use_bitmap=m == 8,
                                            fused=fused))
    od, oi = linear_search(q, index.codes, 10, method="popcount")
    assert torch.equal(res.dists, od.cpu())
    # ids too, but for the codes at a row's kth distance: the stop rule
    # (kth distance at most (radius + 1) * m) may stop before it has seen
    # every code at that distance (ROADMAP.md Queue 3)
    assert bool(((res.ids == oi.cpu())
                 | (res.dists == res.dists[:, -1:])).all())


@pytest.mark.parametrize("nq,k,block", [(300, 10, 512), (8192, 100, 128)])
def test_folded_scan_on_card_matches_twin(cuda_device, monkeypatch, nq, k,
                                          block):
    """scan_blockmin's block selection folded over corpus chunks (a small
    SLICE_ELEMS: four kernel tiles a chunk): each chunk is one kernel
    launch on the whole batch, the last with a ragged block, and the scan
    equals the same scan on the CPU (the twin, one chunk) in dists and
    ids; ties at distance 0 across chunk borders go to the smaller id."""
    from verticut_tpu_torch.ops import hamming
    rng = np.random.default_rng(nq)
    q, db = _codes(rng, nq, 4), _codes(rng, 60_000 + block // 2 + 3, 4)
    for r in (8191, 8192, 16384, 40000, db.shape[0] - 1):
        db[r] = q[1]
    want = hamming.scan_blockmin(q, db, k, block=block)
    monkeypatch.setattr(hamming, "SLICE_ELEMS", nq * 4 * (2048 // block))
    calls = []
    kernel = kb.blockmin

    def counted(queries, rows, n, blk, which=None):
        calls.append(queries.shape[0])
        return kernel(queries, rows, n, blk, which)

    monkeypatch.setattr(kb, "blockmin", counted)
    before = kb.launches_by_instance["tensor"]
    got = hamming.scan_blockmin(q.to(cuda_device), db.to(cuda_device), k,
                                block=block)
    torch.cuda.synchronize()
    n_chunks = -(-db.shape[0] // 8192)
    assert calls == [nq] * n_chunks
    assert kb.launches_by_instance["tensor"] - before == n_chunks
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert want[1][1, :5].tolist() == [8191, 8192, 16384, 40000,
                                       db.shape[0] - 1]


def test_approximate_drivers_agree_on_card(cuda_device):
    packed = codes.clustered_codes(3, 100_000, 128, n_clusters=500,
                                   flip_p=0.02)
    q = bits.as_codes(packed[:512] ^ np.uint32(3), cuda_device)
    index = build_index(packed, MIHConfig(), device=cuda_device)
    scfg = SearchConfig(knn=10, approximate=True)
    a = mih_search(index, q, scfg)
    b = mih_search(index, q, SearchConfig(knn=10, approximate=True,
                                          fused=False))
    assert torch.equal(a.dists, b.dists) and torch.equal(a.ids, b.ids)
    true_d = codes.hamming_distance(index.codes[a.ids.long().cuda()],
                                    q[:, None])
    assert torch.equal(true_d.cpu(), a.dists)


def test_dispatch_copies_to_pinned_memory_behind_an_event(cuda_device):
    """dispatch leaves the packed row on the card, its copy in pinned host
    memory and an event behind the copy; finalize equals mih_search."""
    packed = codes.clustered_codes(4, 100_000, 128, n_clusters=500,
                                   flip_p=0.02)
    index = build_index(packed, MIHConfig(), device=cuda_device)
    q = bits.as_codes(packed[:300] ^ np.uint32(9), cuda_device)
    scfg = SearchConfig(knn=10)
    h = mih_search_dispatch(index, q, scfg)
    assert h.packed.is_cuda and h.packed.shape == (300, 13)
    assert not h.host.is_cuda and h.host.is_pinned()
    assert isinstance(h.event, torch.cuda.Event)
    got = mih_search_finalize(h)
    assert h.event.query()
    assert torch.equal(h.host, h.packed.cpu())
    want = mih_search(index, q, scfg)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_dispatch_runs_on_a_worker_stream(cuda_device, monkeypatch):
    """The fused pipeline runs on a worker thread, on that thread's own
    CUDA stream, not the caller's; two handles in flight equal
    mih_search."""
    from verticut_tpu_torch.search import single
    packed = codes.clustered_codes(4, 100_000, 128, n_clusters=500,
                                   flip_p=0.02)
    index = build_index(packed, MIHConfig(), device=cuda_device)
    q = bits.as_codes(packed[:300] ^ np.uint32(9), cuda_device)
    scfg = SearchConfig(knn=10)
    want = mih_search(index, q, scfg)
    seen, fused_row = [], single._fused_row

    def spy(*a, **kw):
        seen.append((threading.get_ident(), torch.cuda.current_stream()))
        return fused_row(*a, **kw)

    monkeypatch.setattr(single, "_fused_row", spy)
    caller = torch.cuda.current_stream()
    handles = [mih_search_dispatch(index, q, scfg) for _ in range(2)]
    got = [mih_search_finalize(h) for h in handles]
    assert len(seen) >= 2
    for thread, stream in seen:
        assert thread != threading.get_ident() and stream != caller
    for res in got:
        for f in want._fields:
            assert torch.equal(getattr(res, f), getattr(want, f)), f


@pytest.mark.parametrize("method", METHODS)
def test_linear_search_methods_on_card(cuda_device, method):
    rng = np.random.default_rng(6)
    db = bits.as_codes(rng.integers(0, 1 << 32, (200_003, 4),
                                    dtype=np.uint32), cuda_device)
    q = db[:300].clone()
    q[:, 1] ^= 7
    od, oi = linear_search(q, db, 25, method="popcount")
    launches = (kb.launches, kp.launches)
    d, i = linear_search(q, db, 25, method=method)
    assert torch.equal(d, od) and torch.equal(i, oi)
    if method in ("auto", "blockmin"):
        assert kb.launches > launches[0]
    if method == "pallas":
        assert kp.launches > launches[1]


def test_sharded_engines_in_a_world_of_one_on_the_card(cuda_device):
    """Both sharded engines in a one-rank NCCL world (a spawned process),
    against the port's mih_search on the same 20k corpus: dists and the
    four stats equal, ids equal below each row's kth distance."""
    import torch_world_cases as cases
    from verticut_tpu_torch.parallel.world import spawn
    out = spawn(cases.run_world_of_one, 1, device="cuda")[0]
    assert out["backend"] == "nccl" and out["device"].startswith("cuda")
    for case in ("inline_True", "inline_False", "compact"):
        got, want = out[case]
        for f in ("dists", "radius", "n_probes", "n_nonempty", "n_cands"):
            assert np.array_equal(got[f], want[f]), (case, f)
        kth = want["dists"][:, -1:]
        below = want["dists"] < kth
        assert np.array_equal(np.where(below, got["ids"], -1),
                              np.where(below, want["ids"], -1)), case


def test_perf_sweep_search_on_card(cuda_device, capsys, monkeypatch):
    """``perf_sweep search`` on the card: one row per (n, q, k) cell, each
    timed search equal to the popcount oracle, and the scan tier on
    blockmin's tensor-core instance only."""
    from verticut_tpu_torch import search
    from verticut_tpu_torch.ops.hamming import scan_popcount
    from verticut_tpu_torch.search import single
    from verticut_tpu_torch.tools import perf_sweep
    seen = []

    def recorded(index, queries, scfg, *a):
        res = single.mih_search(index, queries, scfg, *a)
        seen.append((index, queries, scfg.knn, res))
        return res

    monkeypatch.setattr(search, "mih_search", recorded)
    before = dict(kb.launches_by_instance)
    perf_sweep.main(["search", "--n", "50000", "--q", "64,3000", "--k",
                     "10,100", "--repeats", "1"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["cell"] for r in rows] == [
        {"n": 50000, "q": q, "k": k} for q in (64, 3000) for k in (10, 100)]
    assert all(r["qps"]["min"] > 0 for r in rows)
    assert len(seen) == 8
    for index, queries, k, res in seen:
        q = bits.as_codes(queries, cuda_device)
        od, oi = scan_popcount(q, index.codes, k)
        assert torch.equal(res.dists, od.cpu()) and torch.equal(
            res.ids, oi.cpu())
    assert kb.launches_by_instance["generic"] == before["generic"]


def test_collective_bench_gather_sweep_on_card(cuda_device, capsys):
    from verticut_tpu_torch.tools import collective_bench
    collective_bench.main(["--max_pow", "9"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("devices: ['cuda:0 ")
    gathers = [ln.split() for ln in lines[1:]]
    assert [int(g[1]) for g in gathers] == [1, 8, 64, 512]
    assert all(g[0] == "gather" and float(g[3]) > 0 for g in gathers)


@pytest.mark.parametrize("block", [128, 512])
def test_forced_generic_instance_on_tensor_shapes(cuda_device, block):
    """profile_scan's and int8_scan_bench's switch: the generic instance
    launched at a shape the tensor-core one takes, equal to the twin and
    to the tensor-core instance, counted under its own name, and the
    scan on either instance equal."""
    rng = np.random.default_rng(block)
    q, db = _codes(rng, 300, 4).cuda(), _codes(rng, 20000, 4).cuda()
    before = dict(kb.launches_by_instance)
    got = kb.blockmin(q, db, 20000, block, "generic")
    torch.cuda.synchronize()
    assert kb.launches_by_instance["generic"] == before["generic"] + 1
    assert kb.launches_by_instance["tensor"] == before["tensor"]
    assert torch.equal(got, kb.blockmin_reference(q, db, 20000, block))
    assert torch.equal(got, kb.blockmin(q, db, 20000, block, "tensor"))
    from verticut_tpu_torch.ops.hamming import scan_blockmin
    a = scan_blockmin(q, db, 10, block=block, which="generic")
    b = scan_blockmin(q, db, 10, block=block)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_profile_tools_on_card(cuda_device, capsys):
    """The profiling tools' mains at small sizes on the card: every check
    holds and the profiled component rows saw kernels."""
    from verticut_tpu_torch.tools import profile_scan, profile_stages2
    rec = profile_stages2.main(["--n", "50000", "--q", "512", "--r", "2"])
    assert all(p["launches"] > 0 and p["device_ms"] > 0
               for p in rec["profile"].values())
    rec = profile_scan.main(["200000", "10", "--q", "256"])
    assert rec["checks"] and all(rec["checks"].values())
