"""The blockmin twin against the Pallas kernels it replaces (interpret
mode, on the CPU) and the port's scans against brute force. Exact
equality throughout. The CUDA kernel's own tests are in test_torch_gpu.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests import reference_model as ref
from verticut_tpu import codes as jcodes
from verticut_tpu.ops import hamming as jhamming
from verticut_tpu.ops.pallas import (pallas_blockmin, pallas_blockmin_t,
                                     pallas_blockmin_t2)
from verticut_tpu_torch import bits
from verticut_tpu_torch.codes import pairwise_hamming
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.ops import hamming
from verticut_tpu_torch.ops.hamming import ENGINES
from verticut_tpu_torch.search import linear_search


def _raw(seed, n, nq):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, 16), dtype=np.uint8),
            rng.integers(0, 256, size=(nq, 16), dtype=np.uint8))


@pytest.mark.parametrize("kernel,nq", [("t", 10), ("t2", 70)])
def test_twin_matches_transposed_kernels_on_full_blocks(kernel, nq):
    """K2 (pallas_blockmin_t) and K1 (pallas_blockmin_t2) take a
    transposed, zero-padded corpus and leave the tail to the caller, so
    they agree with the twin on every block wholly below n."""
    block, n = 512, 63321                       # npad 65536, 123 full blocks
    raw_db, raw_q = _raw(9, n, nq)
    q, db = jcodes.pack_bytes(raw_q), jcodes.pack_bytes(raw_db)
    db_t = jcodes.transpose_scan_layout(jnp.asarray(db))
    if kernel == "t":
        want = pallas_blockmin_t(jnp.asarray(q), db_t, block=block,
                                 interpret=True)
    else:
        want = pallas_blockmin_t2(jnp.asarray(q), db_t, block=block,
                                  sub_q=32, interpret=True)
    got = kb.blockmin_reference(bits.as_codes(q), bits.as_codes(db), n, block)
    nfull = n // block
    assert got.shape == (nq, -(-n // block))
    assert np.array_equal(got[:, :nfull].numpy(), np.asarray(want)[:, :nfull])


@pytest.mark.parametrize("block,n", [(16, 3796), (32, 3990)])
def test_twin_matches_rowmajor_kernel_all_blocks(block, n):
    """K3 (pallas_blockmin) has the twin's contract: rows >= n excluded,
    the straddling block exact, blocks past n at bits + 1."""
    npad = 4096
    raw_db, raw_q = _raw(block, npad, 10)
    raw_db[n:] = 0
    q, db = jcodes.pack_bytes(raw_q), jcodes.pack_bytes(raw_db)
    want = pallas_blockmin(jnp.asarray(q), jnp.asarray(db), n, block=block,
                           interpret=True)
    got = kb.blockmin_reference(bits.as_codes(q), bits.as_codes(db), n, block)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block", [64, 128, 256, 512])
def test_twin_matches_rowmajor_kernel_at_kernel_blocks(block):
    """K3 at the blocks its CUDA counterpart now takes, on a corpus padded
    to 128 * block rows whose last valid block straddles n; the pad rows
    hold random codes, which both sides must ignore."""
    npad = 128 * block
    n = npad - 3 * block - block // 2 - 5
    raw_db, raw_q = _raw(block + 1, npad, 9)
    raw_db[n - 1] = raw_q[0]                    # in the straddling block
    raw_db[n] = raw_q[1]                        # first pad row: excluded
    q, db = jcodes.pack_bytes(raw_q), jcodes.pack_bytes(raw_db)
    want = pallas_blockmin(jnp.asarray(q), jnp.asarray(db), n, block=block,
                           interpret=True)
    got = kb.blockmin(bits.as_codes(q), bits.as_codes(db), n, block)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, (n - 1) // block]) == 0
    assert (got[:, -(-n // block):] == 129).all()


def _adversarial(seed, n, nq):
    raw_db, raw_q = _raw(seed, n, nq)
    raw_db[n - 3] = raw_q[0] ^ np.uint8(1)      # in the straddling block
    raw_db[n - 1] = raw_q[1]
    raw_db[513] = raw_q[0]
    raw_db[7] = raw_q[2]                        # ties at distance 0..1
    raw_db[8] = raw_q[2]
    return raw_db, raw_q


@pytest.mark.parametrize("k", [1, 9, 40])
def test_scans_match_brute_force(k):
    n = 20873
    raw_db, raw_q = _adversarial(11, n, 6)
    ed, ei = ref.brute_force(raw_q, raw_db, k)
    q = bits.as_codes(jcodes.pack_bytes(raw_q))
    db = bits.as_codes(jcodes.pack_bytes(raw_db))
    for block in (128, 512):
        d, i = hamming.scan_blockmin(q, db, k, block=block)
        assert np.array_equal(d.numpy(), ed) and np.array_equal(i.numpy(), ei)
    d, i = hamming.scan_popcount(q, db, k, chunk=4096)
    assert np.array_equal(d.numpy(), ed) and np.array_equal(i.numpy(), ei)
    for method in ("auto", "blockmin", "popcount"):
        d, i = linear_search(jcodes.pack_bytes(raw_q), db, k, method=method)
        assert np.array_equal(d.numpy(), ed) and np.array_equal(i.numpy(), ei)


@pytest.mark.parametrize("engine", ENGINES)
def test_scan_blockmin_engines_match_jax(engine):
    """Every engine of the port runs the same pass 1; each equals the JAX
    scan (its XLA engine: the Pallas one has no CPU mode) and brute
    force, chunk arguments included."""
    n, k = 9000, 12
    raw_db, raw_q = _adversarial(5, n, 7)
    ed, ei = ref.brute_force(raw_q, raw_db, k)
    q = bits.as_codes(jcodes.pack_bytes(raw_q))
    db = bits.as_codes(jcodes.pack_bytes(raw_db))
    jd, ji = jhamming.scan_blockmin(jnp.asarray(jcodes.pack_bytes(raw_q)),
                                    jnp.asarray(jcodes.pack_bytes(raw_db)),
                                    k, chunk=4096, block=256, engine="xla")
    for chunk, block in [(4096, 256), (65536, 512), (512, 64)]:
        d, i = hamming.scan_blockmin(q, db, k, chunk=chunk, block=block,
                                     engine=engine)
        assert np.array_equal(d.numpy(), ed) and np.array_equal(i.numpy(), ei)
        assert np.array_equal(d.numpy(), np.asarray(jd))
        assert np.array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k,block", [(5, 64), (40, 32), (300, 64)])
def test_folded_selection_matches_single_chunk_and_jax(monkeypatch, k,
                                                       block):
    """Block selection folded over corpus chunks: SLICE_ELEMS small enough
    for one kernel tile per chunk gives five chunks with a ragged last
    block, each one blockmin call on the whole batch. Equal to the
    single-chunk run, to the JAX package's folded XLA branch and to brute
    force; query 3 ties at distance 0 across the chunk borders (the 5
    smallest of 7 ids win at k = 5), and k = 300 passes nb = 141."""
    n = 9000 + block // 2 + 3
    raw_db, raw_q = _adversarial(17, n, 9)
    for r in (2047, 2048, 4095, 6144, 8191, 8192, n - 1):
        raw_db[r] = raw_q[3]
    ed, ei = ref.brute_force(raw_q, raw_db, k)
    q = bits.as_codes(jcodes.pack_bytes(raw_q))
    db = bits.as_codes(jcodes.pack_bytes(raw_db))
    whole = hamming.scan_blockmin(q, db, k, block=block)
    calls = []
    twin = kb.blockmin

    def counted(queries, rows, n_rows, blk):
        calls.append((queries.shape[0], rows.shape[0]))
        return twin(queries, rows, n_rows, blk)

    monkeypatch.setattr(kb, "blockmin", counted)
    monkeypatch.setattr(hamming, "SLICE_ELEMS", 9 * (2048 // block))
    folded = hamming.scan_blockmin(q, db, k, block=block)
    assert [c[0] for c in calls] == [9] * 5
    assert [c[1] for c in calls] == [2048] * 4 + [n - 4 * 2048]
    jd, ji = jhamming.scan_blockmin(jnp.asarray(jcodes.pack_bytes(raw_q)),
                                    jnp.asarray(jcodes.pack_bytes(raw_db)),
                                    k, chunk=2048, block=block, engine="xla")
    for d, i in (folded, (jd, ji)):
        assert np.array_equal(np.asarray(d), whole[0].numpy())
        assert np.array_equal(np.asarray(i), whole[1].numpy())
    assert np.array_equal(whole[0].numpy(), ed)
    assert np.array_equal(whole[1].numpy(), ei)
    if k == 5:
        assert whole[1][3].tolist() == [2047, 2048, 4095, 6144, 8191]


def test_scan_blockmin_rejects_what_the_reference_rejects():
    q = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="engine"):
        hamming.scan_blockmin(q, q, 2, engine="mosaic")
    with pytest.raises(ValueError, match="multiple of block"):
        hamming.scan_blockmin(q, q, 2, chunk=1000, block=512)


def test_scans_pad_when_corpus_is_smaller_than_k():
    raw_db, raw_q = _raw(3, 5, 4)
    q = bits.as_codes(jcodes.pack_bytes(raw_q))
    db = bits.as_codes(jcodes.pack_bytes(raw_db))
    ed, ei = ref.brute_force(raw_q, raw_db, 5)
    for d, i in (hamming.scan_blockmin(q, db, 8, block=128),
                 hamming.scan_popcount(q, db, 8)):
        assert np.array_equal(d[:, :5].numpy(), ed)
        assert np.array_equal(i[:, :5].numpy(), ei)
        assert (d[:, 5:] == 0x7FFFFFFF).all() and (i[:, 5:] == -1).all()


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        kb.blockmin(q.to(torch.int64), q.to(torch.int64), 3, 128)
    with pytest.raises(ValueError):
        kb.blockmin(q, torch.zeros((5, 2), dtype=torch.int32), 5, 128)
    with pytest.raises(ValueError):
        kb.blockmin(q, torch.zeros((5, 4), dtype=torch.int32), 6, 128)


def test_instance_choice():
    """(W, block) -> instance for every shape the tests and cells use: the
    tensor cores at 32- to 256-bit codes and power-of-two blocks 32..2048
    (the search paths' blocks 512 and 128, the 64-bit cell's W = 2), the
    generic CUDA-core instance elsewhere."""
    for w in range(1, 9):
        for block in (32, 64, 128, 256, 512, 1024, 2048):
            assert kb.instance(w, block) == "tensor"
    for w, block in ((4, 1), (4, 16), (4, 31), (4, 96), (4, 3000),
                     (4, 4096), (9, 512), (16, 128), (3, 48)):
        assert kb.instance(w, block) == "generic"
    assert kb.INSTANCES == ("tensor", "generic")


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_expanded_operands_give_hamming(w):
    """The mirror of the tensor-core instance's operands: popcount(q) -
    (q8 . c8) / 64 equals the Hamming distance exactly (int32 matmul), and
    every dot is a multiple of 64; sign bits and all-zero / all-ones words
    included."""
    rng = np.random.default_rng(w)
    q = rng.integers(0, 1 << 32, (33, w), dtype=np.uint32)
    c = rng.integers(0, 1 << 32, (70, w), dtype=np.uint32)
    q[0], q[1], c[0], c[1] = 0, 0xFFFFFFFF, 0xFFFFFFFF, 0x80000000
    q, c = bits.as_codes(q), bits.as_codes(c)
    q8, c8 = kb.expand_queries(q), kb.expand_codes(c)
    assert q8.dtype == c8.dtype == torch.int8
    assert q8.shape == (33, 32 * w) and c8.shape == (70, 32 * w)
    assert set(q8.abs().unique().tolist()) <= {1, 2, 4, 8, 16, 32, 64}
    assert set(c8.unique().tolist()) <= {0, 1, 2, 4, 8, 16, 32, 64}
    dot = q8.to(torch.int32) @ c8.to(torch.int32).T
    assert bool((dot % 64 == 0).all())
    pop = bits.popcount32(q).sum(-1, dtype=torch.int32)
    assert torch.equal(pop[:, None] - dot // 64, pairwise_hamming(q, c))
    # byte 32w + 4t + j is bit t + 8j of word w: bit 8 is t 0, j 1
    one = torch.tensor([[1 << 8]], dtype=torch.int32)
    assert kb.expand_codes(one)[0].nonzero().flatten().tolist() == [1]
    assert kb.expand_queries(one)[0, :4].tolist() == [-64, 64, -64, -64]
