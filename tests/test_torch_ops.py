"""verticut_tpu_torch.ops.chunks / topk against verticut_tpu.ops on random
inputs: exact equality (tolerance 0). The JAX selections use inverted
uint32 keys ``~(dist << 24 | id)``; the port's ascending int64 keys equal
their complements, with the sentinel 0xFFFFFFFF for the inverted 0."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from verticut_tpu.ops import chunks as jchunks
from verticut_tpu.ops import topk as jtopk
from verticut_tpu_torch import bits
from verticut_tpu_torch.ops import chunks as tchunks
from verticut_tpu_torch.ops import topk as ttopk

BLK = 25


def _t(a):
    return torch.from_numpy(np.array(a))


def _asc(inv_keys):
    """JAX inverted uint32 keys -> the port's ascending int64 keys."""
    return (~np.asarray(inv_keys, np.uint32)).astype(np.int64)


def _ranges(rng, q, h, n_rows, p_empty=0.3):
    starts = rng.integers(0, n_rows, size=(q, h)).astype(np.int32)
    counts = rng.integers(0, 60, size=(q, h)).astype(np.int32)
    counts[rng.random((q, h)) < p_empty] = 0
    counts = np.minimum(counts, n_rows - starts).astype(np.int32)
    return starts, counts


@pytest.mark.parametrize("chb", [4, 16, 64])
def test_chunk_descriptors_match(chb):
    rng = np.random.default_rng(chb)
    n_rows = 5000
    starts, counts = _ranges(rng, 33, 18, n_rows)
    counts[0] = 0                                   # a query with no chunks
    want = jchunks.chunk_descriptors(jnp.asarray(starts), jnp.asarray(counts),
                                     blk=BLK, chb=chb,
                                     n_blocks=n_rows // BLK)
    got = tchunks.chunk_descriptors(_t(starts), _t(counts), blk=BLK, chb=chb,
                                    n_blocks=n_rows // BLK)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))
    ovf = got[4]
    assert bool(ovf.any()) == (chb < 64) and not ovf.all()


def test_fetch_score_blocks_match_with_pad_ids():
    rng = np.random.default_rng(3)
    nb, w, rw = 40, 4, 5
    rows = rng.integers(0, 1 << 32, size=(nb, BLK * rw), dtype=np.uint32)
    rows[:, :BLK] = rng.permutation(nb * BLK).reshape(nb, BLK)
    rows[-2:, :BLK] = 0xFFFFFFFF                    # pad entries
    rows[-2:, BLK:] = 0
    starts, counts = _ranges(rng, 17, 6, nb * BLK)
    blk_id, lo, hi, _, _ = jchunks.chunk_descriptors(
        jnp.asarray(starts), jnp.asarray(counts), blk=BLK, chb=12,
        n_blocks=nb)
    blk_id = np.asarray(blk_id).copy()
    blk_id[:, -1] = nb - 1                          # always touch pad rows
    hi = np.asarray(hi).copy()
    lo = np.asarray(lo)
    hi[:, -1] = BLK
    q = rng.integers(0, 1 << 32, size=(17, w), dtype=np.uint32)
    q[:5] |= np.uint32(0x80000000)
    want = jchunks.fetch_score_blocks(jnp.asarray(rows), jnp.asarray(blk_id),
                                      jnp.asarray(lo), jnp.asarray(hi),
                                      jnp.asarray(q), blk=BLK)
    got = tchunks.fetch_score_blocks(bits.as_codes(rows), _t(blk_id), _t(lo),
                                     _t(hi), bits.as_codes(q), blk=BLK)
    for g, wnt in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), np.asarray(wnt))


def _cands(rng, q, chb, n_ids=1 << 20, p_invalid=0.4):
    """Chunk-major candidates with ids unique per row (one table, one
    radius step) and invalid slots at (INF, -1)."""
    c = chb * BLK
    ids = np.stack([rng.choice(n_ids, c, replace=False) for _ in range(q)])
    d = rng.integers(0, 129, size=(q, c))
    bad = rng.random((q, c)) < p_invalid
    ids = np.where(bad, -1, ids).astype(np.int32)
    d = np.where(bad, 0x7FFFFFFF, d).astype(np.int32)
    return d, ids


@pytest.mark.parametrize("chb,p", [(44, 10), (232, 10), (44, 100),
                                   (200, 40)])
def test_table_topk_chunkmin_match(chb, p):
    """(44, 100) and (200, 40) take the fallback to table_topk_packed
    (4 * p * blk > C); the others the chunk-min pre-selection."""
    rng = np.random.default_rng(chb + p)
    d, ids = _cands(rng, 24, chb)
    want = _asc(jtopk.table_topk_chunkmin_packed(jnp.asarray(d),
                                                 jnp.asarray(ids), p, BLK))
    got = ttopk.table_topk_chunkmin_packed(_t(d), _t(ids), p, BLK)
    assert np.array_equal(got.numpy(), want)
    plain = ttopk.table_topk_packed(_t(d), _t(ids), p)
    assert np.array_equal(plain.numpy(), want)


@pytest.mark.parametrize("width,m", [(300, 10), (5000, 10), (9000, 100)])
def test_select_asc_matches_select_desc(width, m):
    rng = np.random.default_rng(width)
    d, ids = _cands(rng, 8, width // BLK + 1)
    keys = ttopk.pack_keys(_t(d), _t(ids))[:, :width]
    inv = ~(keys.numpy().astype(np.uint32))
    want = _asc(jtopk.select_desc(jnp.asarray(inv), m))
    assert np.array_equal(ttopk.select_asc(keys, m).numpy(), want)


@pytest.mark.parametrize("p", [10, 100])
def test_merge_strips_and_kth_stats_match(p):
    rng = np.random.default_rng(p)
    q, n_tables = 16, 4
    # a pool and 4 table strips that share ids (the dedup case), with a
    # distance that is a function of the id
    dist_of = rng.integers(0, 129, size=4000).astype(np.int32)
    pool_id = np.stack([rng.choice(4000, p, replace=False) for _ in range(q)])
    pool_id[:, p // 2:] = -1
    pool_id[0] = -1                                 # an empty pool
    pool_dist = np.where(pool_id >= 0, dist_of[pool_id], 0x7FFFFFFF)
    order = np.lexsort((pool_id, pool_dist))
    pool_id = np.take_along_axis(pool_id, order, -1).astype(np.int32)
    pool_dist = np.take_along_axis(pool_dist, order, -1).astype(np.int32)
    strips_j, strips_t = [], []
    for _ in range(n_tables):
        ids = np.stack([rng.choice(600, 3 * p, replace=False)
                        for _ in range(q)]).astype(np.int32)
        ids[:, -p:] = -1
        d = np.where(ids >= 0, dist_of[np.maximum(ids, 0)],
                     0x7FFFFFFF).astype(np.int32)
        strips_j.append(jtopk.table_topk_packed(jnp.asarray(d),
                                                jnp.asarray(ids), p))
        strips_t.append(ttopk.table_topk_packed(_t(d), _t(ids), p))
    want = jtopk.merge_strips_packed(jnp.asarray(pool_dist),
                                     jnp.asarray(pool_id),
                                     jnp.concatenate(strips_j, -1),
                                     n_copies=n_tables + 1)
    got = ttopk.merge_strips_packed(_t(pool_dist), _t(pool_id),
                                    torch.cat(strips_t, -1),
                                    n_copies=n_tables + 1)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for k in (1, p // 2, p):
        kw = jtopk.kth_stats(want[0], want[1], k)
        kg = ttopk.kth_stats(got[0], got[1], k)
        for g, w in zip(kg, kw, strict=True):
            assert np.array_equal(g.numpy(), np.asarray(w))


def _scan_keys(d, i):
    """JAX (dist, id) rows -> the port's ascending ``dist << 32 | id``."""
    return (np.asarray(d).astype(np.int64) << 32) | np.asarray(i)


@pytest.mark.parametrize("t,k", [(700, 10), (5000, 100), (6144, 7), (5, 9)])
def test_chunk_topk_affine_and_merge_match(t, k):
    """Chunk selection with many ties (distances 0..15), at widths that
    take the JAX blockwise and wide-strip branches, then a merge of two
    chunks into a running pool; ties go to the lower id on both sides."""
    rng = np.random.default_rng(t + k)
    q = 6
    d0 = rng.integers(0, 16, size=(q, t)).astype(np.int32)
    d1 = rng.integers(0, 16, size=(q, t)).astype(np.int32)
    kk = min(k, t)
    jd, ji = jtopk.chunk_topk_affine(jnp.asarray(d0), 0, k, t)
    got0 = ttopk.chunk_topk_affine(_t(d0), 0, k)
    assert got0.shape == (q, kk)
    assert np.array_equal(got0.numpy(), _scan_keys(jd, ji)[:, :kk])
    cd, ci = jtopk.chunk_topk_affine(jnp.asarray(d1), t, k, t)
    got1 = ttopk.chunk_topk_affine(_t(d1), t, k)
    pool = ttopk.merge_topk(ttopk.merge_topk(got0.new_empty((q, 0)), got0, k),
                            got1, k)
    if kk == k:
        md, mi = jtopk.merge_topk_packed(jd, ji, cd, ci)
        assert np.array_equal(pool.numpy(), _scan_keys(md, mi))
    both = np.concatenate([d0, d1], -1)
    order = np.lexsort((np.broadcast_to(np.arange(2 * t), both.shape), both),
                       axis=-1)[:, :min(k, 2 * t)]
    want = _scan_keys(np.take_along_axis(both, order, -1), order)
    assert np.array_equal(pool.numpy(), want)
