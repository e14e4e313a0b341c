"""verticut_tpu_torch.ops.chunks / topk and the bucket engine's
expand_buckets against verticut_tpu on random inputs: exact equality
(tolerance 0). The JAX selections use inverted
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


@pytest.mark.parametrize("cap", [64, 256, 2048])
def test_expand_buckets_matches_jax(cap):
    """Entries, validity and totals of the bucket engine's slot expansion,
    bit-equal to the JAX package's (its default lowering at these shapes),
    invalid slots included: empty probes, a query with no candidates, and
    totals past the cap (truncated; the caller flags overflow)."""
    from verticut_tpu.search.single import expand_buckets as jexpand
    from verticut_tpu_torch.search.single import expand_buckets
    rng = np.random.default_rng(cap)
    starts, counts = _ranges(rng, 29, 37, 100_000)
    counts[0] = 0
    counts[1, :] = 0
    counts[1, -1] = 7                               # only the last probe
    got = expand_buckets(_t(starts), _t(counts), cap)
    want = jexpand(jnp.asarray(starts), jnp.asarray(counts), cap)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))
    total = got[2].numpy()
    assert (total > cap).any() == (cap < 2048) and (total <= cap).any()
    assert got[1][1].sum() == 7 and not got[1][0].any()


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


def _wide_cands(rng, q, c, max_id, base=0):
    """The JAX package's _pos-test candidates (``tests/test_ops.py``): ids
    unique per row (the per-table invariant), a distance that is a
    function of the id (many ties), ids up to ``base + max_id``."""
    cid = np.full((q, c), -1, np.int64)
    for i in range(q):
        k = rng.integers(0, c + 1)
        cid[i, :k] = rng.choice(max_id, size=k, replace=False) + base
    cdist = np.where(cid >= 0, (cid * 13 + 5) % 120, 0x7FFFFFFF)
    return cdist.astype(np.int32), cid.astype(np.int32)


def _by_dist_id(d, i, p):
    """Brute-force top-``p`` per row by (dist, id), padded with (INF, -1)."""
    out_d = np.full((d.shape[0], p), 0x7FFFFFFF, np.int32)
    out_i = np.full((d.shape[0], p), -1, np.int32)
    for r in range(d.shape[0]):
        ok = i[r] >= 0
        order = np.lexsort((i[r][ok], d[r][ok]))[:p]
        out_d[r, :len(order)] = d[r][ok][order]
        out_i[r, :len(order)] = i[r][ok][order]
    return out_d, out_i


@pytest.mark.parametrize("q,blk,chb,p,max_id,base", [
    (6, 32, 20, 7, 100_000, 0),                  # test_chunkmin_strip_...
    (5, 32, 24, 9, 90_000_000, (1 << 25) + 7),   # test_chunkmin_pos_huge_ids
    (4, 25, 8, 4, 3000, 0),                      # the fallback (4p*blk > C)
    (6, 25, 44, 10, (1 << 30) - 9, (1 << 30) - 1),  # ids up to 2^31 - 1
])
def test_pos_selections_match_jax(q, blk, chb, p, max_id, base):
    """table_topk_pos and table_topk_chunkmin_pos: equal to each other and
    to brute force by (dist, id), and to the JAX selections in every
    distance. The JAX ones order a strip by (dist, slot) and keep a
    table's first slots at an equal distance (ROADMAP.md Queue 3), so
    their ids may differ at the kth-distance ties; on rows without such a
    tie they hold the same ids, which sort by (dist, id) to the port's."""
    rng = np.random.default_rng(blk * chb + p)
    d, i = _wide_cands(rng, q, blk * chb, max_id, base)
    d[0, 3 * blk:3 * blk + p] = 0            # all winners in one chunk
    i[0, 3 * blk:3 * blk + p] = np.arange(p) + base + max_id
    want_d, want_i = _by_dist_id(d, i, p)
    jd, ji = jtopk.table_topk_pos(jnp.asarray(d), jnp.asarray(i), p)
    jcd, jci = jtopk.table_topk_chunkmin_pos(jnp.asarray(d), jnp.asarray(i),
                                             p, blk)
    for got in (ttopk.table_topk_pos(_t(d), _t(i), p),
                ttopk.table_topk_chunkmin_pos(_t(d), _t(i), p, blk)):
        assert np.array_equal(got[0].numpy(), want_d)
        assert np.array_equal(got[1].numpy(), want_i)
        kth = want_d[:, -1:]
        untied = ((d == kth) & (i >= 0)).sum(-1) <= (want_d == kth).sum(-1)
        for jdd, jii in ((jd, ji), (jcd, jci)):
            assert np.array_equal(got[0].numpy(), np.asarray(jdd))
            jd_s, ji_s = _by_dist_id(np.asarray(jdd), np.asarray(jii), p)
            assert np.array_equal(got[1].numpy()[untied], ji_s[untied])


@pytest.mark.parametrize("p,base", [(7, 0), (7, (1 << 25) + 12345),
                                    (60, 0), (10, (1 << 31) - 300)])
def test_merge_strips_dedup_pos_matches_jax(p, base):
    """Three rounds of the wide-id merge over three tables' strips that
    share ids: bit-equal to the JAX merge given the same strips, and equal
    to brute force by (dist, id) over every candidate seen."""
    rng = np.random.default_rng(p + base % 97)
    q, n_tables, c, max_id = 6, 3, 40, 250
    pd, pi = ttopk.empty_pool(q, p)
    seen = [dict() for _ in range(q)]
    for _ in range(3):
        strips = []
        for _t_ in range(n_tables):
            d, i = _wide_cands(rng, q, c, max_id, base)
            for r in range(q):
                seen[r].update({int(a): int(b) for a, b in zip(i[r], d[r])
                                if a >= 0})
            strips.append(ttopk.table_topk_pos(_t(d), _t(i), p))
        sd = torch.cat([s_[0] for s_ in strips], -1)
        si = torch.cat([s_[1] for s_ in strips], -1)
        want = jtopk.merge_strips_dedup_pos(
            jnp.asarray(pd.numpy()), jnp.asarray(pi.numpy()),
            jnp.asarray(sd.numpy()), jnp.asarray(si.numpy()))
        pd, pi = ttopk.merge_strips_dedup_pos(pd, pi, sd, si)
        assert np.array_equal(pd.numpy(), np.asarray(want[0]))
        assert np.array_equal(pi.numpy(), np.asarray(want[1]))
    for r in range(q):
        best = sorted(seen[r].items(), key=lambda kv: (kv[1], kv[0]))[:p]
        assert [(int(a), int(b)) for a, b in zip(pi[r], pd[r])
                ][:len(best)] == best
        assert (pi[r, len(best):] == -1).all()
