"""verticut_tpu_torch.codes / bits against verticut_tpu.codes: exact
equality (tolerance 0; every quantity is an integer)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from verticut_tpu import codes as jcodes
from verticut_tpu_torch import bits
from verticut_tpu_torch import codes as tcodes
from verticut_tpu_torch.ops import topk


def _top_bit_codes(rng, n, w=4):
    """Random codes with the top bit of every word forced on for half the
    rows: int32 views of those words are negative (the sign trap)."""
    c = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint32)
    c[: n // 2] |= np.uint32(0x80000000)
    c[0] = 0xFFFFFFFF
    c[1] = 0x80000000
    return c


def test_host_generators_byte_equal():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(37, 16), dtype=np.uint8)
    assert np.array_equal(tcodes.pack_bytes(raw), jcodes.pack_bytes(raw))
    packed = jcodes.pack_bytes(raw)
    assert np.array_equal(tcodes.unpack_to_bytes(packed),
                          jcodes.unpack_to_bytes(packed))
    assert np.array_equal(tcodes.random_codes(5, 1000, 128),
                          jcodes.random_codes(5, 1000, 128))
    for n, ncl, p in [(5000, 50, 0.02), (3000, 7, 0.05)]:
        a = tcodes.clustered_codes(3, n, 128, n_clusters=ncl, flip_p=p)
        b = jcodes.clustered_codes(3, n, 128, n_clusters=ncl, flip_p=p)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_popcount32_edges_and_random():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x55555555,
                  0xAAAAAAAA], np.uint32),
        rng.integers(0, 1 << 32, 5000, dtype=np.uint32)])
    want = np.unpackbits(x.view(np.uint8)).reshape(len(x), 32).sum(-1)
    got = bits.popcount32(bits.as_codes(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_tables", [4, 8, 16])
def test_all_substrings_match(n_tables):
    c = _top_bit_codes(np.random.default_rng(n_tables), 300)
    want = np.asarray(jcodes.all_substrings(jnp.asarray(c), n_tables))
    got = bits.to_u32(tcodes.all_substrings(bits.as_codes(c), n_tables))
    assert np.array_equal(got, want)


def test_hamming_and_pairwise_match():
    rng = np.random.default_rng(2)
    a = _top_bit_codes(rng, 64)
    b = _top_bit_codes(rng, 90)
    want = np.asarray(jcodes.pairwise_hamming(jnp.asarray(a), jnp.asarray(b)))
    got = tcodes.pairwise_hamming(bits.as_codes(a), bits.as_codes(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    want_e = np.asarray(jcodes.hamming_distance(jnp.asarray(a),
                                                jnp.asarray(b[:64])))
    got_e = tcodes.hamming_distance(bits.as_codes(a), bits.as_codes(b[:64]))
    assert np.array_equal(got_e.numpy(), want_e)


def test_pack_keys_order_and_roundtrip():
    d = torch.tensor([[3, 0, 128, 3, 7]], dtype=torch.int32)
    i = torch.tensor([[5, 9, (1 << 24) - 1, 2, -1]], dtype=torch.int32)
    k = topk.pack_keys(d, i)
    assert k[0, 4] == topk.SENTINEL_KEY
    assert torch.argsort(k[0]).tolist() == [1, 3, 0, 2, 4]
    dd, ii = topk.unpack_keys(k)
    assert dd.tolist() == [[3, 0, 128, 3, 0x7FFFFFFF]]
    assert ii.tolist() == [[5, 9, (1 << 24) - 1, 2, -1]]


def test_unpack_bits_pm1_matches():
    rng = np.random.default_rng(4)
    c = _top_bit_codes(rng, 9)
    want = np.asarray(jcodes.unpack_bits_pm1(jnp.asarray(c), jnp.float32))
    got = tcodes.unpack_bits_pm1(bits.as_codes(c))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    # the dot of two +-1 rows is B - 2 * hamming
    dot = got @ got.T
    ham = tcodes.pairwise_hamming(bits.as_codes(c), bits.as_codes(c))
    assert torch.equal(dot.to(torch.int32), 128 - 2 * ham)



@pytest.mark.parametrize("n_bytes,dtype", [(16, torch.float32),
                                           (16, torch.bfloat16),
                                           (32, torch.bfloat16),
                                           (8, torch.float32)])
def test_hamming_via_matmul_matches(n_bytes, dtype):
    """The +-1 GEMM on the reference's inputs (tests/test_codes.py's
    case): equal to JAX's and to the popcount distances, in float32 and,
    up to 256 bits, bfloat16."""
    rng = np.random.default_rng(4)
    q = jcodes.pack_bytes(rng.integers(0, 256, size=(8, n_bytes),
                                       dtype=np.uint8))
    db = jcodes.pack_bytes(rng.integers(0, 256, size=(33, n_bytes),
                                        dtype=np.uint8))
    qpm = np.array(jcodes.unpack_bits_pm1(jnp.asarray(q), jnp.float32))
    dpm = np.array(jcodes.unpack_bits_pm1(jnp.asarray(db), jnp.float32))
    want = np.asarray(jcodes.hamming_via_matmul(jnp.asarray(qpm),
                                                jnp.asarray(dpm)))
    got = tcodes.hamming_via_matmul(torch.from_numpy(qpm).to(dtype),
                                    torch.from_numpy(dpm).to(dtype))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.asarray(jcodes.pairwise_hamming(
        jnp.asarray(q), jnp.asarray(db))))

def test_clustered_codes_device_is_deterministic():
    """Shape and dtype; the same codes for the same seed, other codes for
    another seed. (jax.random draws other numbers than a torch.Generator,
    so the JAX generator is matched in distribution, not in bits.)"""
    a = tcodes.clustered_codes_device(3, 5000, 128, n_clusters=20,
                                      device="cpu")
    assert a.shape == (5000, 4) and a.dtype == torch.int32
    assert torch.equal(a, tcodes.clustered_codes_device(
        3, 5000, 128, n_clusters=20, device="cpu"))
    assert not torch.equal(a, tcodes.clustered_codes_device(
        4, 5000, 128, n_clusters=20, device="cpu"))
    assert tcodes.clustered_codes_device(0, 7, 64, device="cpu").shape == (7,
                                                                            2)


def test_clustered_codes_device_chunks(monkeypatch):
    """N not a multiple of the chunk: every row generated, each chunk
    drawing on from the same generator."""
    monkeypatch.setattr(tcodes, "DEVICE_GEN_CHUNK", 1000)
    a = tcodes.clustered_codes_device(5, 3500, 256, n_clusters=3,
                                      flip_p=0.25, device="cpu")
    assert a.shape == (3500, 8)
    # rows of one cluster differ in about 2 * 0.25 * 0.75 of their bits;
    # a row left unwritten or copied would show as a duplicate
    assert torch.unique(a, dim=0).shape[0] == 3500


@pytest.mark.parametrize("flip_p,bits_w", [(0.02, 128), (0.05, 64),
                                           (0.3, 256)])
def test_clustered_codes_device_flip_rate(flip_p, bits_w):
    """One cluster: each bit differs from the center (the bitwise majority
    code, for flip rates under one half) with probability
    round(flip_p * 256) / 256; the mean share of differing bits lies within
    4 sigma of it, as does the JAX generator's."""
    n = 20_000
    p = round(flip_p * 256) / 256
    sigma = (p * (1 - p) / (n * bits_w)) ** 0.5
    for c in (bits.to_u32(tcodes.clustered_codes_device(
                  11, n, bits_w, n_clusters=1, flip_p=flip_p, device="cpu")),
              np.asarray(jcodes.clustered_codes_device(11, n, bits_w,
                                                       n_clusters=1,
                                                       flip_p=flip_p))):
        b = np.unpackbits(c.view(np.uint8), axis=1)
        center = b.mean(0) > 0.5
        assert abs((b != center).mean() - p) < 4 * sigma


def test_entry_points_default_to_the_card():
    """Given no device, clustered_codes_device and linear_search on numpy
    codes run on the card, and raise where there is none; tensors stay
    where they lie."""
    from verticut_tpu_torch.search import linear_search
    q, db = tcodes.random_codes(1, 5, 128), tcodes.random_codes(2, 50, 128)
    calls = (lambda: tcodes.clustered_codes_device(0, 8),
             lambda: linear_search(q, db, 3)[0])
    if torch.cuda.is_available():
        for call in calls:
            assert call().device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert tcodes.clustered_codes_device(0, 8, device="cpu").device.type == \
        "cpu"
    d, _ = linear_search(q, bits.as_codes(db), 3)
    assert d.device.type == "cpu"
    d, _ = linear_search(bits.as_codes(q), db, 3)
    assert d.device.type == "cpu"
