"""The port's mih_search against the JAX package's fused mih_search, the
slice as a whole: equal dists, ids, radius, n_probes, n_nonempty and
n_cands (tolerance 0) on the same corpus, index and queries."""

import os
import subprocess
import sys

import numpy as np
import pytest

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index as jax_build_index
from verticut_tpu.search import mih_search as jax_mih_search
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                       mih_search_finalize)
import verticut_tpu_torch.search.single as single

N = 200_000
CFG = MIHConfig(bits=128, n_tables=4)
FIELDS = ("dists", "ids", "radius", "n_probes", "n_nonempty", "n_cands")


def _perturbed(packed, nq, seed):
    """Random corpus rows with 3 random bit flips each (as bench.py)."""
    rng = np.random.default_rng(seed)
    q = packed[rng.integers(0, len(packed), nq)].copy()
    pos = rng.integers(0, 128, (nq, 3))
    for j in range(3):
        np.bitwise_xor.at(q, (np.arange(nq), pos[:, j] // 32),
                          np.uint32(1) << (pos[:, j] % 32).astype(np.uint32))
    return q


def _assert_parity(port_index, jax_index, queries, scfg):
    got = mih_search(port_index, queries, scfg)
    want = jax_mih_search(jax_index, queries, scfg)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    return got


@pytest.fixture(scope="module")
def clustered():
    packed = jcodes.clustered_codes(0, N, 128, n_clusters=N // 200,
                                    flip_p=0.02)
    return (packed, build_index(packed, CFG, device="cpu"),
            jax_build_index(packed, CFG, directory="range"))


@pytest.mark.parametrize("uniform,nq,k", [(False, 64, 10), (False, 64, 100),
                                          (False, 2048, 10),
                                          (True, 1024, 10)])
def test_mih_search_matches_jax(clustered, uniform, nq, k):
    packed, port_index, jax_index = clustered
    q = (jcodes.random_codes(99, nq, 128) if uniform
         else _perturbed(packed, nq, seed=nq + k))
    scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
    got = _assert_parity(port_index, jax_index, q, scfg)
    if uniform:
        # the dominance gate skipped every stage after the first and the
        # scan ladder resolved the whole batch
        assert (got.radius == 1).all()
    else:
        assert (got.dists[:, 0] <= 3).all()         # planted neighbour


def test_overflow_retry_ladders_match_jax(monkeypatch):
    """A heavily clustered corpus and a small candidate_cap overflow the
    stage budgets: the device retry ladder runs, and rows it cannot fix
    take the 4x-cap host retry."""
    packed = jcodes.clustered_codes(1, N, 128, n_clusters=50, flip_p=0.02)
    q = _perturbed(packed, 64, seed=5)
    scfg = SearchConfig(knn=10, candidate_cap=2000, max_enum_radius=5)
    calls = {"states": 0, "retries": 0}
    init_state, search = single.init_state, single.mih_search

    def count_states(*a, **kw):
        calls["states"] += 1
        return init_state(*a, **kw)

    def count_retries(index, queries, scfg, _cap=None):
        calls["retries"] += _cap is not None
        return search(index, queries, scfg, _cap)

    monkeypatch.setattr(single, "init_state", count_states)
    monkeypatch.setattr(single, "mih_search", count_retries)
    _assert_parity(build_index(packed, CFG, device="cpu"),
                   jax_build_index(packed, CFG, directory="range"), q, scfg)
    assert calls["retries"] >= 1
    # the top call's state, its retry ladder's, and each host retry's
    assert calls["states"] >= 2 + calls["retries"]


def test_unported_options_raise():
    packed = jcodes.random_codes(3, 500, 128)
    index = build_index(packed, CFG, device="cpu")
    q = packed[:4]
    for kw, item in [({"fused": False}, "item 1"),
                     ({"approximate": True}, "item 2"),
                     ({"overflow_to_scan": True}, "item 3"),
                     ({"fused_max_masks": 0}, "item 1")]:
        with pytest.raises(NotImplementedError, match=item):
            mih_search(index, q, SearchConfig(**kw))
    with pytest.raises(NotImplementedError, match="item 3"):
        mih_search_dispatch(index, q)
    with pytest.raises(NotImplementedError, match="item 3"):
        mih_search_finalize(None)
    with pytest.raises(ValueError):
        mih_search(index, q, SearchConfig(use_bitmap=True))
    with pytest.raises(ValueError):
        mih_search(index, q[:, :2], SearchConfig())
    # past the crossover an approximate request runs the exact engine
    r = mih_search(index, q, SearchConfig(knn=60, approximate=True))
    e = mih_search(index, q, SearchConfig(knn=60))
    assert np.array_equal(r.dists.numpy(), e.dists.numpy())


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import verticut_tpu_torch, verticut_tpu_torch.index, "
        "verticut_tpu_torch.search, verticut_tpu_torch.ops.hamming, "
        "verticut_tpu_torch.kernels.blockmin\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'verticut_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
