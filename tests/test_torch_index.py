"""verticut_tpu_torch.index against the JAX package's range builds: every
array byte-equal (tolerance 0)."""

import numpy as np
import pytest

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig
from verticut_tpu.index import build_index as jax_build_index
from verticut_tpu.index.build_native import build_index_native
from verticut_tpu.index.mih import save_index
from verticut_tpu_torch import bits
from verticut_tpu_torch.index import build_index, index_from_arrays
from verticut_tpu_torch.search import mih_search
from verticut_tpu_torch.config import SearchConfig


def _assert_same(port, ref):
    assert port.n == ref.n
    assert np.array_equal(bits.to_u32(port.codes), np.asarray(ref.codes))
    for tp, tr in zip(port.tables, ref.tables, strict=True):
        assert tp.directory.pbits == tr.directory.pbits
        assert np.array_equal(tp.directory.se.numpy(),
                              np.asarray(tr.directory.se))
        assert np.array_equal(bits.to_u32(tp.entry_rows),
                              np.asarray(tr.entry_rows))
        assert np.array_equal(tp.entry_ids.numpy(),
                              np.asarray(tr.entry_ids))


@pytest.mark.parametrize("n", [1000, 200_000])
def test_build_matches_jax_builds(n):
    packed = jcodes.clustered_codes(4, n, 128, n_clusters=max(2, n // 200),
                                    flip_p=0.02)
    packed[:3] |= np.uint32(0x80000000)       # substrings >= 2^31
    cfg = MIHConfig(bits=128, n_tables=4)
    port = build_index(packed, cfg, device="cpu")
    _assert_same(port, jax_build_index(packed, cfg, directory="range"))
    _assert_same(port, build_index_native(packed, cfg, directory="range"))


def test_index_from_saved_jax_index(tmp_path):
    packed = jcodes.random_codes(6, 3000, 128)
    cfg = MIHConfig(bits=128, n_tables=4)
    ref = jax_build_index(packed, cfg, directory="range")
    path = str(tmp_path / "idx.npz")
    save_index(path, ref)
    with np.load(path) as z:
        port = index_from_arrays(dict(z), device="cpu")
    _assert_same(port, ref)
    own = build_index(packed, cfg, device="cpu")
    q = packed[:40] ^ np.uint32(3)
    a = mih_search(port, q, SearchConfig(knn=5))
    b = mih_search(own, q, SearchConfig(knn=5))
    for f in a._fields:
        assert np.array_equal(getattr(a, f).numpy(), getattr(b, f).numpy()), f


def test_unported_layouts_raise():
    packed = jcodes.random_codes(7, 100, 128)
    with pytest.raises(NotImplementedError, match="item 8"):
        build_index(packed, MIHConfig(), device="cpu", directory="dense")
    arrays = {"n": np.asarray(100), "bits": np.asarray(128),
              "n_tables": np.asarray(4), "codes": packed}
    with pytest.raises(NotImplementedError):
        index_from_arrays(arrays, device="cpu")
    with pytest.raises(ValueError):
        build_index(packed[:, :2], MIHConfig(), device="cpu")
