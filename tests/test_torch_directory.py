"""verticut_tpu_torch.index.directory and .bitmap against the JAX
package's: every directory's lookup equal to JAX's on the same sorted
keys (tolerance 0), keys and probes at and above 2^31 included, and the
built arrays equal where both packages build them on the device."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from verticut_tpu.index import bitmap as jbitmap
from verticut_tpu.index import directory as jdir
from verticut_tpu_torch import bits
from verticut_tpu_torch.index import bitmap as tbitmap
from verticut_tpu_torch.index import directory as tdir


def _lookup_np(sorted_vals, v):
    lo = np.searchsorted(sorted_vals, v, side="left")
    hi = np.searchsorted(sorted_vals, v, side="right")
    return lo, hi - lo


def _keys_and_probes(seed, hot, n_uniform, width=32):
    """Sorted uint32 keys (hot values plus a uniform tail) and probes:
    random values, the hot values, the extremes and keys themselves."""
    rng = np.random.default_rng(seed)
    top = 1 << width
    keys = np.sort(np.concatenate([
        rng.choice(hot, size=500),
        rng.integers(0, top, size=n_uniform, dtype=np.uint64)]).astype(
            np.uint32))
    probe = np.concatenate([
        rng.integers(0, top, size=300, dtype=np.uint64).astype(np.uint32),
        np.asarray(hot + [0, top - 1], np.uint32),
        keys[rng.integers(0, len(keys), 100)]])
    return keys, probe


def _same_lookup(port_dir, jax_dir, probe):
    s, c = port_dir.lookup(bits.as_codes(probe))
    js, jc = jax_dir.lookup(jnp.asarray(probe))
    assert s.dtype == c.dtype == torch.int32
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert np.array_equal(s.numpy(), np.asarray(js))
    return s.numpy(), c.numpy()


HOT32 = [7, 42, 0xFFFFFFF0, 0x80000001, 0x80000000]


@pytest.mark.parametrize("kind", ["sorted", "prefix"])
def test_sorted_and_prefix_match_jax_across_2_31(kind):
    keys, probe = _keys_and_probes(0, HOT32, 1500)
    assert (keys >= 1 << 31).sum() > 500 and (probe >= 1 << 31).sum() > 100
    tk = bits.as_codes(keys)
    if kind == "sorted":
        got, want = tdir.build_sorted(tk), jdir.build_sorted(jnp.asarray(keys))
    else:
        got, want = (tdir.build_prefix(tk, 32),
                     jdir.build_prefix(jnp.asarray(keys), 32))
        assert (got.shift, got.iters) == (want.shift, want.iters)
        assert np.array_equal(got.prefix_offsets.numpy(),
                              np.asarray(want.prefix_offsets))
        assert np.array_equal(got.run_end.numpy(), np.asarray(want.run_end))
    assert np.array_equal(bits.to_u32(got.keys), keys)
    s, c = _same_lookup(got, want, probe)
    el, ec = _lookup_np(keys, probe)
    assert np.array_equal(c, ec) and np.array_equal(s, el)


@pytest.mark.parametrize("s_bits,n", [(8, 1000), (16, 5000)])
def test_dense_matches_jax(s_bits, n):
    rng = np.random.default_rng(s_bits)
    keys = np.sort(rng.integers(0, 1 << s_bits, size=n).astype(np.uint32))
    got = tdir.build_dense(bits.as_codes(keys), s_bits)
    want = jdir.build_dense(jnp.asarray(keys), s_bits)
    assert got.s_bits == want.s_bits == s_bits
    assert np.array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    probe = np.arange(1 << s_bits, dtype=np.uint32)
    _same_lookup(got, want, probe)
    with pytest.raises(ValueError, match="infeasible"):
        tdir.build_dense(bits.as_codes(keys), 32)


@pytest.mark.parametrize("s_bits", [8, 16])
def test_prefix_small_sbits_matches_jax(s_bits):
    rng = np.random.default_rng(2 + s_bits)
    keys = np.sort(rng.integers(0, 1 << s_bits, size=777).astype(np.uint32))
    got = tdir.build_prefix(bits.as_codes(keys), s_bits)
    want = jdir.build_prefix(jnp.asarray(keys), s_bits)
    assert (got.shift, got.iters) == (want.shift, want.iters)
    _same_lookup(got, want, np.arange(1 << s_bits, dtype=np.uint32))


def test_hash_matches_jax():
    """The port's copy of the cuckoo builder, against the JAX package's
    rows and lookups; misses read (0, 0) in both."""
    keys, probe = _keys_and_probes(3, HOT32 + [0], 1500)
    got = tdir.build_hash(bits.as_codes(keys))
    want = jdir.build_hash(keys)
    assert np.array_equal(bits.to_u32(got.rows), np.asarray(want.rows))
    s, c = _same_lookup(got, want, probe)
    el, ec = _lookup_np(keys, probe)
    assert np.array_equal(c, ec)
    assert np.array_equal(s[ec > 0], el[ec > 0]) and (s[ec == 0] == 0).all()


def test_hash_tiny_duplicate_and_xor_family_keys():
    """All-duplicate keys, and MIH substring families (center ^ a few bit
    flips), which wedge a linear hash: the table builds at the 0.4 load
    factor without growing, and lookups stay exact."""
    hd = tdir.build_hash(torch.zeros(64, dtype=torch.int32))
    s, c = hd.lookup(torch.tensor([0, 1], dtype=torch.int32))
    assert c.tolist() == [64, 0] and int(s[0]) == 0
    rng = np.random.default_rng(0)
    centers = rng.integers(0, 1 << 32, 2000, dtype=np.uint32)
    flips = np.uint32(1) << rng.integers(0, 32, (2000, 40)).astype(np.uint32)
    keys = np.sort((centers[:, None] ^ flips).reshape(-1))
    uniq = int((keys[1:] != keys[:-1]).sum()) + 1
    rows = tdir.build_hash(bits.as_codes(keys))
    assert rows.rows.shape[0] == 1 << max(3, int(np.ceil(np.log2(uniq / 0.4))))
    probe = keys[rng.integers(0, len(keys), 500)]
    _same_lookup(rows, jdir.build_hash(keys), probe)


def test_mix_matches_jax_on_extremes():
    v = np.asarray([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF],
                   np.uint32)
    u = bits.as_codes(v).to(torch.int64) & 0xFFFFFFFF
    for ca, cb in tdir.HASH_CONSTS:
        want = np.asarray(jdir._mix(jnp.asarray(v), ca, cb))
        assert np.array_equal(tdir._mix(u, ca, cb).numpy(),
                              want.astype(np.int64))


@pytest.mark.parametrize("s_bits,pbits", [(32, None), (16, None), (16, 16),
                                          (32, 24)])
def test_range_matches_jax(s_bits, pbits):
    keys, _ = _keys_and_probes(5, [3, 1 << (s_bits - 1)], 2000, s_bits)
    got = tdir.build_range(bits.as_codes(keys), s_bits, pbits=pbits)
    want = jdir.build_range(jnp.asarray(keys), s_bits, pbits=pbits)
    assert got.pbits == want.pbits
    assert np.array_equal(got.se.numpy(), np.asarray(want.se))


def test_compute_run_end_and_pick_pbits_match_jax():
    keys = np.sort(np.random.default_rng(9).integers(
        0, 50, 400).astype(np.uint32))
    assert np.array_equal(
        tdir.compute_run_end(bits.as_codes(keys)).numpy(),
        np.asarray(jdir.compute_run_end(jnp.asarray(keys))))
    for n in (0, 1, 2, 1000, 1 << 30):
        for s in (8, 16, 32):
            assert tdir.pick_pbits(n, s) == jdir.pick_pbits(n, s)


@pytest.mark.parametrize("s_bits", [8, 16, 24])
def test_bitmap_matches_jax(s_bits):
    keys, probe = _keys_and_probes(s_bits, [0, (1 << s_bits) - 1, 31, 32],
                                   700, s_bits)
    got = tbitmap.build_bitmap(bits.as_codes(keys), s_bits)
    want = jbitmap.build_bitmap(jnp.asarray(keys), s_bits)
    assert np.array_equal(bits.to_u32(got.words), np.asarray(want.words))
    assert np.array_equal(got.get(bits.as_codes(probe)).numpy(),
                          np.asarray(want.get(jnp.asarray(probe))))
    assert int(got.count()) == int(want.count()) == len(np.unique(keys))
    both = got.union(tbitmap.Bitmap(words=got.words.flip(0)))
    assert np.array_equal(
        bits.to_u32(both.words),
        np.asarray(want.union(jbitmap.Bitmap(words=want.words[::-1])).words))
