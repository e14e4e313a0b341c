"""The port's encoders against the JAX package's (models/lsh.py).

``encode`` is held bit for bit to the reference's given the reference's
arrays, on features whose projections stay clear of 0 (float rounding
there may flip a sign in either package). ``fit`` draws from a
``torch.Generator``, not ``jax.random``, so it is held to the properties
of tests/test_models.py's four tests. The code-file reader and writer are
held against the reference's, both ways.
"""

import numpy as np
import torch

import jax.numpy as jnp

from verticut_tpu import codes as jcodes
from verticut_tpu.models import ITQEncoder as JaxITQ
from verticut_tpu.models import RandomProjectionLSH as JaxLSH
from verticut_tpu.models.lsh import write_code_file as jax_write_code_file
from verticut_tpu import native

from verticut_tpu_torch import codes
from verticut_tpu_torch.bits import to_u32
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.models import ITQEncoder, RandomProjectionLSH
from verticut_tpu_torch.models.lsh import encode_corpus, write_code_file
from verticut_tpu_torch.search import linear_search, mih_search

#: a projection closer to 0 than this may round to either sign
CLEAR = 1e-3


def _features(n, d=256, seed=0, n_clusters=16, noise=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] + noise * rng.normal(size=(n, d))
            ).astype(np.float32), assign


def _cluster_gap(packed, assign):
    """Mean Hamming distance across clusters minus within them, over the
    first 200 rows against all."""
    pc = torch.from_numpy(packed.view(np.int32))
    d = codes.pairwise_hamming(pc[:200], pc).numpy()
    same = (assign[:200, None] == assign[None, :])
    np.fill_diagonal(same[:, :200], False)
    return d[~same].mean() - d[same].mean()


def test_lsh_encode_is_bit_equal_to_jax():
    x, _ = _features(500, seed=4)
    jenc = JaxLSH.create(256, 128, seed=7)
    proj = np.asarray(jnp.asarray(x) @ jenc.projection)
    keep = (np.abs(proj) > CLEAR).all(axis=1)
    assert keep.sum() > 100
    enc = RandomProjectionLSH(torch.from_numpy(np.array(jenc.projection)))
    got = to_u32(enc.encode(x[keep]))
    assert np.array_equal(got, np.asarray(jenc.encode(jnp.asarray(x[keep]))))
    # the pack is the byte layout of codes.pack_bytes
    expect = codes.pack_bytes(np.packbits(proj[keep] >= 0, axis=1,
                                          bitorder="little"))
    assert np.array_equal(got, expect)


def test_itq_encode_is_bit_equal_to_jax():
    x, _ = _features(600, seed=5)
    jenc = JaxITQ.fit(jnp.asarray(x[:400]), bits=128, n_iters=5)
    z = np.asarray((jnp.asarray(x) - jenc.mean) @ jenc.w @ jenc.r)
    keep = (np.abs(z) > CLEAR).all(axis=1)
    assert keep.sum() > 100
    enc = ITQEncoder(*(torch.from_numpy(np.array(a))
                       for a in (jenc.mean, jenc.w, jenc.r)))
    assert np.array_equal(to_u32(enc.encode(x[keep])),
                          np.asarray(jenc.encode(jnp.asarray(x[keep]))))


def test_lsh_deterministic_and_packed():
    x, _ = _features(100)
    enc = RandomProjectionLSH.create(256, 128, seed=7, device="cpu")
    again = RandomProjectionLSH.create(256, 128, seed=7, device="cpu")
    assert torch.equal(enc.projection, again.projection)
    c1, c2 = to_u32(enc.encode(x)), to_u32(again.encode(x))
    assert c1.shape == (100, 4) and c1.dtype == np.uint32
    assert np.array_equal(c1, c2)
    proj = x @ enc.projection.numpy()
    expect = codes.pack_bytes(np.packbits(proj >= 0, axis=1,
                                          bitorder="little"))
    assert (c1 != expect).sum() <= (np.abs(proj) < CLEAR).sum()


def test_lsh_preserves_neighborhoods():
    x, assign = _features(2000, seed=1)
    enc = RandomProjectionLSH.create(256, 128, device="cpu")
    assert _cluster_gap(to_u32(enc.encode(x)), assign) > 10


def test_itq_beats_or_matches_lsh_quantization():
    """ITQ's codes keep the clusters apart, and its learned rotation
    quantizes the PCA projections with less error than the random rotation
    it starts from (the property ITQ is fitted for)."""
    x, assign = _features(3000, seed=2)
    itq = ITQEncoder.fit(x[:2000], bits=128, n_iters=20, device="cpu")
    again = ITQEncoder.fit(x[:2000], bits=128, n_iters=20, device="cpu")
    for a, b in zip(itq, again):
        assert torch.equal(a, b)                 # deterministic per seed
    packed = to_u32(itq.encode(x))
    assert packed.shape == (3000, 4)
    assert _cluster_gap(packed, assign) > 10
    v = (torch.from_numpy(x[:2000]) - itq.mean) @ itq.w
    start = ITQEncoder.fit(x[:2000], bits=128, n_iters=0, device="cpu")

    def quant_err(r):
        z = v @ r
        return float(((torch.sign(z) + (z == 0).float()) - z).square().sum())

    assert quant_err(itq.r) <= quant_err(start.r)


def test_end_to_end_encode_index_search(tmp_path):
    """Features -> ITQ codes -> code file -> index -> MIH search finds the
    feature-space neighbors (the full reference pipeline, closed loop)."""
    x, assign = _features(4000, seed=3, noise=0.05)
    itq = ITQEncoder.fit(x[:2000], bits=128, n_iters=15, device="cpu")
    packed = encode_corpus(itq, x, batch=1024)
    assert packed.dtype == np.uint32
    p = str(tmp_path / "lsh.code")
    write_code_file(p, packed)
    loaded = codes.read_code_file(p, 16, 10**6)
    assert np.array_equal(loaded, packed)

    idx = build_index(loaded, MIHConfig(), device="cpu")
    q = torch.from_numpy(loaded[:32].view(np.int32))
    res = mih_search(idx, q, SearchConfig(fused=False, knn=10,
                                          candidate_cap=2048))
    ld, _ = linear_search(q, idx.codes, 10, method="popcount")
    assert torch.equal(res.dists, ld)
    frac_same = (assign[np.clip(res.ids.numpy(), 0, None)]
                 == assign[:32, None]).mean()
    assert frac_same > 0.9, frac_same


def test_encode_corpus_keeps_tensors_on_the_device():
    x, _ = _features(300, seed=6)
    enc = RandomProjectionLSH.create(256, 64, seed=1, device="cpu")
    t = encode_corpus(enc, torch.from_numpy(x), batch=128)
    assert t.dtype == torch.int32 and t.shape == (300, 2)
    assert np.array_equal(to_u32(t), encode_corpus(enc, x, batch=100))


def test_encode_corpus_of_no_rows_keeps_the_code_width():
    enc = RandomProjectionLSH.create(256, 64, seed=1, device="cpu")
    got = encode_corpus(enc, np.zeros((0, 256), np.float32))
    assert got.dtype == np.uint32 and got.shape == (0, 2)
    t = encode_corpus(enc, torch.zeros((0, 256)))
    assert t.dtype == torch.int32 and t.shape == (0, 2)


def test_code_files_read_across_packages(tmp_path):
    packed = jcodes.random_codes(3, 1000, 128)
    a, b = str(tmp_path / "jax.code"), str(tmp_path / "port.code")
    jax_write_code_file(a, packed)
    write_code_file(b, torch.from_numpy(packed.view(np.int32)))
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        for max_codes in (10**6, 1000, 337):
            got = codes.read_code_file(path, 16, max_codes)
            assert np.array_equal(got, native.read_code_file(path, 16,
                                                             max_codes))
    # a trailing partial row is dropped, as the reference's fread loop does
    with open(b, "ab") as f:
        f.write(b"\x01\x02\x03")
    assert np.array_equal(codes.read_code_file(b, 16, 10**6), packed)
    assert np.array_equal(native.read_code_file(b, 16, 10**6), packed)
