"""Tests of verticut_tpu_torch that need an NVIDIA GPU: the CUDA blockmin
kernel against its plain twin, and the search path on the card against
the popcount oracle. Exact equality throughout. They skip without CUDA.

This file imports neither jax nor verticut_tpu, so on a machine without
JAX it runs apart from tests/conftest.py:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from verticut_tpu_torch import bits, codes
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.search import linear_search, mih_search

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("nq,n_rows,n", [(70, 5000, 4711), (129, 40000, 39999),
                                         (300, 1000, 0), (8192, 100000, 99999)])
def test_kernel_matches_twin(cuda_device, nq, n_rows, n):
    rng = np.random.default_rng(nq)
    q = bits.as_codes(rng.integers(0, 1 << 32, (nq, 4), dtype=np.uint32))
    db = bits.as_codes(rng.integers(0, 1 << 32, (n_rows, 4),
                                    dtype=np.uint32))
    db[5] = q[0]
    q, db = q.to(cuda_device), db.to(cuda_device)
    for block in kb.KERNEL_BLOCKS:
        before = kb.launches
        got = kb.blockmin(q, db, n, block)
        torch.cuda.synchronize()
        assert kb.launches == before + 1
        assert torch.equal(got, kb.blockmin_reference(q, db, n, block))


@pytest.mark.parametrize("uniform", [False, True])
def test_mih_search_on_card_matches_oracle(cuda_device, uniform):
    packed = codes.clustered_codes(2, 100_000, 128, n_clusters=500,
                                   flip_p=0.02)
    q = (codes.random_codes(9, 1024, 128) if uniform
         else packed[:1024] ^ np.uint32(5))
    index = build_index(packed, MIHConfig(), device=cuda_device)
    before = kb.launches
    res = mih_search(index, q, SearchConfig(knn=10))
    od, oi = linear_search(q, index.codes, 10, method="popcount")
    assert torch.equal(res.dists, od) and torch.equal(res.ids, oi)
    if uniform:                       # the full-batch scan ran the kernel
        assert kb.launches > before
