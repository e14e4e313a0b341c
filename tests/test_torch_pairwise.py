"""The pairwise twin against the Pallas kernel it replaces (K4, interpret
mode on the CPU), and the port's full-matrix scans and every
linear_search method against the JAX package's method of the same name
and against brute force. Exact equality throughout. The CUDA kernel's own
tests are in test_torch_gpu.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests import reference_model as ref
from verticut_tpu import codes as jcodes
from verticut_tpu.ops import hamming as jhamming
from verticut_tpu.ops.pallas import pallas_pairwise_hamming
from verticut_tpu.search import linear_search as jax_linear_search
from verticut_tpu_torch import bits
from verticut_tpu_torch.kernels import pairwise as kp
from verticut_tpu_torch.ops import hamming
from verticut_tpu_torch.search import linear_search
from verticut_tpu_torch.search.linear import METHODS


def _raw(seed, n, nq):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, 16), dtype=np.uint8),
            rng.integers(0, 256, size=(nq, 16), dtype=np.uint8))


def _adversarial(seed, n, nq):
    """Ties at distance 0 and 1, and near neighbours in the last rows."""
    raw_db, raw_q = _raw(seed, n, nq)
    raw_db[n - 2] = raw_q[0] ^ np.uint8(1)
    raw_db[n - 1] = raw_q[1]
    raw_db[3] = raw_q[0]
    raw_db[4] = raw_q[2]
    raw_db[5] = raw_q[2]
    raw_db[6] = raw_q[2] ^ np.uint8(4)
    raw_db[9] = raw_q[2] ^ np.uint8(8)
    return raw_db, raw_q


def _codes(raw):
    return bits.as_codes(jcodes.pack_bytes(raw))


@pytest.mark.parametrize("nq,n", [(256, 512), (512, 1024)])
def test_twin_matches_pallas_pairwise(nq, n):
    raw_db, raw_q = _raw(nq + n, n, nq)
    raw_db[7] = raw_q[0]
    raw_q[1] = ~raw_db[0]                       # distance 128
    want = pallas_pairwise_hamming(jnp.asarray(jcodes.pack_bytes(raw_q)),
                                   jnp.asarray(jcodes.pack_bytes(raw_db)),
                                   interpret=True)
    got = kp.pairwise(_codes(raw_q), _codes(raw_db))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_twin_takes_any_shape():
    """No tile padding: odd Q and N, and empty sides."""
    raw_db, raw_q = _raw(5, 1001, 3)
    q, db = _codes(raw_q), _codes(raw_db)
    want = np.unpackbits(raw_q[:, None, :] ^ raw_db[None, :, :],
                         axis=-1).sum(-1)
    assert np.array_equal(kp.pairwise_reference(q, db).numpy(), want)
    assert kp.pairwise(q[:0], db).shape == (0, 1001)
    assert kp.pairwise(q, db[:0]).shape == (3, 0)


@pytest.mark.parametrize("k", [1, 7, 40])
def test_full_matrix_scans_match_jax_and_brute_force(k):
    """scan_pallas and scan_matmul over a corpus that no chunk divides,
    with ties, against the JAX scans of the same name and brute force."""
    n = 3001
    raw_db, raw_q = _adversarial(k, n, 11)
    ed, ei = ref.brute_force(raw_q, raw_db, k)
    q, db = _codes(raw_q), _codes(raw_db)
    jq = jnp.asarray(jcodes.pack_bytes(raw_q))
    jdb = jnp.asarray(jcodes.pack_bytes(raw_db))
    for name, port, jax_scan in [
            ("pallas", hamming.scan_pallas,
             lambda: jhamming.scan_pallas(jq, jdb, k, chunk=1024,
                                          interpret=True)),
            ("matmul", hamming.scan_matmul,
             lambda: jhamming.scan_matmul(jq, jdb, k, chunk=1024))]:
        for chunk in (1000, 1024, 65536):
            d, i = port(q, db, k, chunk=chunk)
            assert np.array_equal(d.numpy(), ed), (name, chunk)
            assert np.array_equal(i.numpy(), ei), (name, chunk)
        jd, ji = jax_scan()
        assert np.array_equal(d.numpy(), np.asarray(jd)), name
        assert np.array_equal(i.numpy(), np.asarray(ji)), name


def test_scans_bound_the_slab(monkeypatch):
    """The [Q, chunk] slab stays under SLICE_ELEMS elements whatever chunk
    says: shrinking the bound cuts the corpus into more chunks and changes
    no result."""
    raw_db, raw_q = _adversarial(2, 2500, 9)
    q, db = _codes(raw_q), _codes(raw_db)
    ed, ei = ref.brute_force(raw_q, raw_db, 10)
    widths = []
    pairwise = kp.pairwise

    def spy(queries, rows):
        widths.append(rows.shape[0])
        return pairwise(queries, rows)

    monkeypatch.setattr(hamming, "SLICE_ELEMS", 9 * 300)
    monkeypatch.setattr(kp, "pairwise", spy)
    d, i = hamming.scan_pallas(q, db, 10, chunk=131072)
    assert max(widths) == 300 and sum(widths) == 2500
    assert np.array_equal(d.numpy(), ed) and np.array_equal(i.numpy(), ei)
    d, i = hamming.scan_matmul(q, db, 10, chunk=131072)
    assert np.array_equal(d.numpy(), ed) and np.array_equal(i.numpy(), ei)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,k", [(3001, 10), (700, 100), (5, 8)])
def test_linear_search_methods_match_jax(method, n, k):
    """Every method against the JAX linear_search under the same name
    (its "pallas" runs K4 in interpret mode here) and brute force,
    including k > n."""
    raw_db, raw_q = _adversarial(n + k, n, 10) if n > 10 else _raw(n, n, 10)
    got_d, got_i = linear_search(jcodes.pack_bytes(raw_q), _codes(raw_db), k,
                                 method=method)
    want_d, want_i = jax_linear_search(jcodes.pack_bytes(raw_q),
                                       jcodes.pack_bytes(raw_db), k,
                                       method=method)
    assert np.array_equal(got_d.numpy(), np.asarray(want_d))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    ed, ei = ref.brute_force(raw_q, raw_db, k)
    m = min(k, n)
    assert np.array_equal(got_d[:, :m].numpy(), ed)
    assert np.array_equal(got_i[:, :m].numpy(), ei)
    assert (got_d[:, m:] == 0x7FFFFFFF).all() and (got_i[:, m:] == -1).all()


def test_linear_search_methods_at_an_unaligned_corpus():
    """N = 20873 is a multiple of no chunk or tile. (The JAX blockmin
    method raises there, ROADMAP.md Queue 3, so this holds the port to
    brute force alone.)"""
    n, k = 20873, 9
    raw_db, raw_q = _adversarial(1, n, 6)
    ed, ei = ref.brute_force(raw_q, raw_db, k)
    for method in METHODS:
        d, i = linear_search(jcodes.pack_bytes(raw_q), _codes(raw_db), k,
                             method=method, chunk=4096)
        assert np.array_equal(d.numpy(), ed), method
        assert np.array_equal(i.numpy(), ei), method


def test_linear_search_slices_large_query_batches(monkeypatch):
    """The blockmin method cuts the batch as the reference does (at most
    max(256, 2^31 / (k * block * W * 4)) queries per scan)."""
    calls = []
    scan = hamming.scan_blockmin

    def spy(queries, db, k, **kw):
        calls.append(queries.shape[0])
        return scan(queries, db, k, **kw)

    monkeypatch.setattr(hamming, "scan_blockmin", spy)
    raw_db, raw_q = _raw(4, 600, 300)
    # k = 5000, block 128: 2^31 / (5000 * 128 * 16) = 209, so the floor
    # of 256 queries per slice applies
    d, i = linear_search(jcodes.pack_bytes(raw_q), _codes(raw_db), 5000,
                         method="blockmin")
    assert calls == [256, 44]
    ed, ei = ref.brute_force(raw_q, raw_db, 600)
    assert np.array_equal(d[:, :600].numpy(), ed)
    assert np.array_equal(i[:, :600].numpy(), ei)


def test_unknown_method_and_bad_inputs_raise():
    q = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown method"):
        linear_search(q, q, 2, method="xla")
    with pytest.raises(TypeError):
        kp.pairwise(q.to(torch.int64), q.to(torch.int64))
    with pytest.raises(ValueError):
        kp.pairwise(q, torch.zeros((5, 2), dtype=torch.int32))
