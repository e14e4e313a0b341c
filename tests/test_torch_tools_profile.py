"""The profiling tools' fused-pipeline variants against the JAX package.

``tools/_profile.fused_variant`` is how the port's ``profile_tiers`` and
``profile_fused_ablate`` run the fused pipeline with pieces switched off.
Each variant's packed result row (``[Q, k + 3]``: the top-k as ``dist <<
id_bits | id`` words, then the flags word with done, overflow, radius and
n_probes, then n_nonempty and n_cands) must be bit-equal (tolerance 0) to
the JAX package's ``fused_pipeline_packed`` called, in this process on the
CPU, with the keyword arguments the JAX tool computes for that variant
(``tools/profile_tiers.py:58-77``, ``tools/profile_fused_ablate.py:
88-121``), on the same corpus, index and queries, at k = 10 and 100. The
JAX index keeps no transposed copy on the CPU, so its scan tier is the XLA
``scan_blockmin`` and reaches no Pallas kernel.

Also: the tiers' done and overflow counts, the full variant against the
dispatched production row, and the CPU paths of the blockmin instance
switch and of the split block-min scan.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig, SearchConfig as JaxSearchConfig
from verticut_tpu.index import build_index as jax_build_index
from verticut_tpu.index.mih import entry_block_size
from verticut_tpu.search import single as jsingle
from verticut_tpu_torch import bench
from verticut_tpu_torch.bits import as_codes
from verticut_tpu_torch.config import SearchConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.ops import hamming
from verticut_tpu_torch.search import mih_search_dispatch, single
from verticut_tpu_torch.tools import _profile, profile_tiers
from verticut_tpu_torch.tools.profile_fused_ablate import VARIANTS

N = 50_000
NQ = 512
CFG = MIHConfig(bits=128, n_tables=4)


@pytest.fixture(scope="module")
def corpus():
    packed = jcodes.clustered_codes(0, N, 128, n_clusters=N // 200,
                                    flip_p=0.02)
    port = build_index(packed, CFG, device="cpu")
    jax_index = jax_build_index(packed, CFG, directory="range")
    queries = {
        False: bench.perturbed_queries(np.random.default_rng(0), port.codes,
                                       NQ),
        True: as_codes(jcodes.random_codes(99, NQ, 128)),
    }
    return port, jax_index, queries


def _scfg(k):
    return JaxSearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)


def _jax_schedule(index, scfg, mask_bits):
    return tuple(
        (r, g) for r, g in jsingle._radius_schedule(scfg, CFG, index.n,
                                                    mask_bits, True)
        if sum(jsingle.enumeration.n_masks(mask_bits, x) for x in g)
        <= scfg.fused_max_masks)


def jax_tiers_kwargs(index, nq, k, *, retry, scan):
    """``tools/profile_tiers.py:58-77``, the tool's arithmetic as written."""
    scfg = _scfg(k)
    mask_bits = jsingle._index_mask_bits(index)
    blk = entry_block_size(CFG.n_words)
    schedule = _jax_schedule(index, scfg, mask_bits)
    caps = tuple(jsingle._cap_for_radius(scfg, CFG, index.n, g,
                                         scfg.pool_size, mask_bits, True, blk)
                 for _, g in schedule)
    batch_caps = tuple(
        nq if i == 0 else max(64, nq >> (jsingle._stage_shift(k, index.n)
                                         + 2 * (i - 1)))
        for i in range(len(schedule)))
    return dict(
        masks=tuple(jsingle._device_masks(mask_bits, g) for _, g in schedule),
        schedule=schedule, caps=caps, batch_caps=batch_caps,
        n_tables=CFG.n_tables, knn=k, pool_size=scfg.pool_size,
        approximate=False, use_bitmap=False, s_bits=CFG.s_bits,
        retry_caps=(tuple(min(c * 2, max(scfg.candidate_cap, c))
                          for c in caps) if retry else None),
        retry_budget=min(nq, max(64, nq // 4)),
        scan_budget=min(nq, max(64, nq // 64)) if scan else 0)


def jax_ablate_kwargs(index, nq, k, *, scan=True, retry=True, n_stages=None,
                      dominance=True, overflow_to_scan=False):
    """``tools/profile_fused_ablate.py:88-121``, the tool's arithmetic as
    written (``ovf_scan`` is ``overflow_to_scan`` here)."""
    scfg = _scfg(k)
    mask_bits = jsingle._index_mask_bits(index)
    schedule = _jax_schedule(index, scfg, mask_bits)
    if n_stages is not None:
        schedule = schedule[:n_stages]
    caps = tuple(jsingle._cap_for_radius(scfg, CFG, index.n, g,
                                         scfg.pool_size, mask_bits, True,
                                         jsingle._index_fetch_blk(index))
                 for _, g in schedule)
    batch_caps = tuple(
        nq if i == 0 else max(64, nq >> (jsingle._stage_shift(k, index.n)
                                         + 2 * (i - 1)))
        for i in range(len(schedule)))
    retry_caps = tuple(min(c * 2, max(scfg.candidate_cap, c)) for c in caps)
    scan_budget = min(nq, max(64, nq // 64)) if scan else 0
    o2s = (overflow_to_scan and scan_budget > 0
           and index.n <= jsingle.OVERFLOW_SCAN_MAX_N)
    return dict(
        masks=tuple(jsingle._device_masks(mask_bits, g) for _, g in schedule),
        schedule=schedule, caps=caps, batch_caps=batch_caps,
        n_tables=CFG.n_tables, knn=k, pool_size=scfg.pool_size,
        approximate=False, use_bitmap=False, s_bits=CFG.s_bits,
        retry_caps=(retry_caps if retry and not o2s and retry_caps != caps
                    else None),
        retry_budget=min(nq, max(64, nq // 4)) if retry and not o2s else 0,
        scan_budget=scan_budget,
        scan_dominance=nq // 2 if scan_budget and dominance else 0,
        overflow_to_scan=o2s)


#: (tool, variant) -> (fused_variant switches, JAX kwargs builder, uniform)
CASES = {}
for _retry, _scan in profile_tiers.VARIANTS:
    CASES[("tiers", f"retry={int(_retry)} scan={int(_scan)}")] = (
        profile_tiers.variant_kwargs(_retry, _scan),
        lambda i, nq, k, r=_retry, s=_scan: jax_tiers_kwargs(
            i, nq, k, retry=r, scan=s),
        False)
for _label, (_kw, _uni) in VARIANTS.items():
    CASES[("ablate", _label)] = (
        _kw, lambda i, nq, k, kw=_kw: jax_ablate_kwargs(i, nq, k, **kw), _uni)

_rows = {}


def _both_rows(corpus, case, k):
    """(port row as uint32, JAX row as uint32) of one variant, cached."""
    if (case, k) not in _rows:
        port, jax_index, queries = corpus
        kw, jax_kw, uniform = CASES[case]
        q = queries[uniform]
        got = _profile.fused_variant(port, q, SearchConfig(
            knn=k, candidate_cap=8192, max_enum_radius=5), **kw)
        jkw = jax_kw(jax_index, NQ, k)
        masks = jkw.pop("masks")
        want = jsingle.fused_pipeline_packed(
            jax_index.tables, jax_index.codes, jax_index.codes_t,
            jax_index.codes_rows, jnp.asarray(q.numpy().view(np.uint32)),
            masks, **jkw)
        _rows[case, k] = (got.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))
    return _rows[case, k]


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("case", list(CASES), ids="-".join)
def test_variant_rows_match_jax(corpus, case, k):
    """Dists, ids, done, overflow, radius, n_probes, n_nonempty and n_cands
    of every row, bit for bit."""
    got, want = _both_rows(corpus, case, k)
    assert got.shape == want.shape == (NQ, k + 3)
    assert np.array_equal(got, want)
    port = corpus[0]
    a = single._unpack_row(torch.from_numpy(got.view(np.int32)), k,
                           single._result_id_bits(port.tables, 128))
    assert (a["dists"][:, 0] <= 64).all()


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("retry,scan", profile_tiers.VARIANTS)
def test_tier_counts_match_jax(corpus, k, retry, scan):
    """profile_tiers' done and overflow counts, from the flags word, equal
    those of JAX's row; without the retry ladder some rows overflow, with
    it none is left overflowed here."""
    case = ("tiers", f"retry={int(retry)} scan={int(scan)}")
    got, want = _both_rows(corpus, case, k)
    port = corpus[0]
    counts = _profile.tier_counts(port, torch.from_numpy(got.view(np.int32)),
                                  k)
    flags = want[:, k]
    assert counts == (int((flags & 1).sum()), int(((flags >> 1) & 1).sum()))
    assert (counts[1] > 0) != retry


def test_full_variant_is_the_dispatched_row(corpus):
    """From 1024 queries the search paths' dominance gate is the tools'
    ``nq // 2``: the full variant's row is the dispatched pipeline's."""
    port = corpus[0]
    q = bench.perturbed_queries(np.random.default_rng(1), port.codes, 1024)
    scfg = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    h = mih_search_dispatch(port, q, scfg)
    assert torch.equal(_profile.fused_variant(port, q, scfg), h.packed)


def test_variants_finish_exact(corpus):
    """Every variant's row, finished by the host fallbacks, is
    mih_search's answer (the tools' check), here for the bare first
    stage, whose unfinished rows all take the fallback scan."""
    from verticut_tpu_torch.search import mih_search
    port, _, queries = corpus
    scfg = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    row = _profile.fused_variant(port, queries[False], scfg, scan=False,
                                 retry=False, n_stages=1)
    assert _profile.tier_counts(port, row, 10)[0] < NQ
    assert _profile.finalized_equal(port, queries[False], scfg, row,
                                    mih_search(port, queries[False], scfg))


@pytest.mark.parametrize("which", kb.INSTANCES)
def test_blockmin_instance_switch_on_the_cpu(which):
    """A CPU tensor takes the twin whichever instance is asked for."""
    rng = np.random.default_rng(4)
    q = as_codes(jcodes.random_codes(5, 33, 128))
    db = as_codes(rng.integers(0, 1 << 32, (1000, 4), dtype=np.uint64)
                  .astype(np.uint32))
    assert torch.equal(kb.blockmin(q, db, 1000, 128, which),
                       kb.blockmin_reference(q, db, 1000, 128))


def test_blockmin_unknown_instance_raises():
    q = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown blockmin instance"):
        kb.blockmin(q, q, 2, 32, "fast")


@pytest.mark.parametrize("block", [128, 512])
def test_select_blocks_then_rescore_is_scan_blockmin(block):
    """The scan split as profile_scan times it: pass 1, then the rescore
    of the selected blocks, equals scan_blockmin, on either instance."""
    db = as_codes(jcodes.clustered_codes(2, 20_000, 128, n_clusters=100,
                                         flip_p=0.02))
    q = as_codes(jcodes.random_codes(6, 64, 128))
    want = hamming.scan_blockmin(q, db, 10, block=block)
    for which in kb.INSTANCES:
        bidx = hamming.select_blocks(q, db, 10, block, which)
        assert bidx.shape == (64, 10)
        d, i = hamming._rescore_blocks(q, db, db.shape[0], bidx, 10, block)
        assert torch.equal(d, want[0]) and torch.equal(i, want[1])
        got = hamming.scan_blockmin(q, db, 10, block=block, which=which)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_timing_helpers():
    """Both protocols time a call; R-rep needs R >= 2; the profiled call
    on the CPU sees no device interval."""
    calls = []
    fn = lambda: calls.append(1)  # noqa: E731
    assert _profile.best_ms(fn, "cpu", reps=3) >= 0 and len(calls) == 4
    assert isinstance(_profile.rep_ms(fn, "cpu", r=3, tries=2), float)
    assert len(calls) == 4 + 1 + 2 * (1 + 3)
    with pytest.raises(ValueError):
        _profile.rep_ms(fn, "cpu", r=1)
    prof = _profile.profiled(lambda: torch.ones(8).sum(), "cpu")
    assert prof["launches"] == 0 and prof["device_ms"] is None


def test_blockmin_bound():
    """The bound is the int8 operations at the card's peak where they
    outweigh the bytes (a wide batch), else the bytes."""
    ms, by = _profile.blockmin_bound(8192, 1_000_000, 4, 512)
    assert by == "operations"
    assert ms == pytest.approx(2 * 8192 * 1e6 * 128 / 1979e12 * 1e3)
    assert _profile.blockmin_bound(1, 1_000_000, 4, 512)[1] == "bytes"
