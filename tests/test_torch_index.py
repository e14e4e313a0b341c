"""verticut_tpu_torch.index against the JAX package's builds, range and
bucket tables: every array byte-equal (tolerance 0), and files saved by
either package loaded by the other."""

import numpy as np
import pytest
import torch

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig
from verticut_tpu.index import build_index as jax_build_index
from verticut_tpu.index.build_native import build_index_native
from verticut_tpu.index.mih import load_index as jax_load_index
from verticut_tpu.index.mih import save_index
from verticut_tpu.search import linear_search as jax_linear_search
from verticut_tpu.search import mih_search as jax_mih_search
from verticut_tpu_torch import bits
from verticut_tpu_torch.index import (build_index, index_from_arrays,
                                      load_index)
from verticut_tpu_torch.index import save_index as port_save_index
from verticut_tpu_torch.search import mih_search
from verticut_tpu_torch.config import SearchConfig


#: each directory's arrays, by attribute name in both packages
DIR_ARRAYS = {"RangeDirectory": ("se",), "DenseDirectory": ("offsets",),
              "SortedDirectory": ("keys",), "HashDirectory": ("rows",),
              "PrefixDirectory": ("prefix_offsets", "keys", "run_end")}


def _u32(x):
    return (bits.to_u32(x) if isinstance(x, torch.Tensor)
            else np.asarray(x).view(np.uint32))


def _assert_same(port, ref):
    """Every array of the two indexes equal, None where the other is."""
    assert port.n == ref.n
    assert (port.cfg.bits, port.cfg.n_tables) == (ref.cfg.bits,
                                                  ref.cfg.n_tables)
    assert np.array_equal(bits.to_u32(port.codes), np.asarray(ref.codes))
    for tp, tr in zip(port.tables, ref.tables, strict=True):
        kind = type(tp.directory).__name__
        assert kind == type(tr.directory).__name__
        for f in DIR_ARRAYS[kind]:
            assert np.array_equal(_u32(getattr(tp.directory, f)),
                                  _u32(getattr(tr.directory, f))), f
        if kind == "PrefixDirectory":
            assert (tp.directory.shift, tp.directory.iters) == (
                tr.directory.shift, tr.directory.iters)
        assert (tp.bitmap is None) == (tr.bitmap is None)
        if tp.bitmap is not None:
            assert np.array_equal(_u32(tp.bitmap.words),
                                  _u32(tr.bitmap.words))
        for f in ("entry_rows", "entry_idrows", "entry_ids", "entry_codes"):
            a, b = getattr(tp, f), getattr(tr, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert np.array_equal(_u32(a), _u32(b)), f


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


@pytest.mark.parametrize("store_codes,keep_ids", [(True, False),
                                                 (False, True),
                                                 (False, False)])
def test_build_options_match_jax(store_codes, keep_ids):
    """The compact layout (id-only rows) and the builds without the flat
    id column, array for array; then a search of each, equal to JAX's
    (the compact branch of the candidate fetch) and to brute force."""
    packed = jcodes.clustered_codes(21, 3000, 128, n_clusters=12, flip_p=0.03)
    cfg = MIHConfig(bits=128, n_tables=4)
    port = build_index(packed, cfg, device="cpu", store_codes=store_codes,
                       keep_entry_ids=keep_ids)
    ref = jax_build_index(packed, cfg, directory="range",
                          store_codes=store_codes, keep_entry_ids=keep_ids)
    _assert_same(port, ref)
    q = packed[:64]
    for scfg in (SearchConfig(knn=10),
                 SearchConfig(fused=False, knn=5, max_enum_radius=3,
                              candidate_cap=1024, fallback_ratio=1e9)):
        got = mih_search(port, q, scfg)
        want = jax_mih_search(ref, q, scfg)
        for f in got._fields:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
        od, oi = jax_linear_search(q, packed, scfg.knn, method="popcount")
        assert np.array_equal(got.dists.numpy(), np.asarray(od))
        assert np.array_equal(got.ids.numpy(), np.asarray(oi))


@pytest.mark.parametrize("store_codes,keep_ids", [(True, True),
                                                 (True, False),
                                                 (False, False)])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_across_packages(tmp_path, writer, store_codes, keep_ids):
    """A file written by either package loads in the other: same arrays,
    and the same search answers from the loaded index as from the one
    built in memory."""
    packed = jcodes.random_codes(11, 1500, 128)
    cfg = MIHConfig(bits=128, n_tables=4)
    port = build_index(packed, cfg, device="cpu", store_codes=store_codes,
                       keep_entry_ids=keep_ids)
    ref = jax_build_index(packed, cfg, directory="range",
                          store_codes=store_codes, keep_entry_ids=keep_ids)
    path = str(tmp_path / "idx.npz")
    if writer == "port":
        port_save_index(path, port)
        port2, ref2 = load_index(path, device="cpu"), jax_load_index(path)
    else:
        save_index(path, ref)
        port2, ref2 = load_index(path, device="cpu"), jax_load_index(path)
    _assert_same(port2, ref)
    _assert_same(port, ref2)
    q = packed[:32] ^ np.uint32(5)
    scfg = SearchConfig(knn=5)
    a, b = mih_search(port2, q, scfg), jax_mih_search(ref2, q, scfg)
    c = mih_search(port, q, scfg)
    for f in a._fields:
        assert np.array_equal(getattr(a, f).numpy(),
                              np.asarray(getattr(b, f))), f
        assert np.array_equal(getattr(a, f).numpy(),
                              getattr(c, f).numpy()), f


def test_unported_layouts_raise():
    """Every directory and table layout of the reference is ported; what
    still raises is what the reference cannot hold either: an unknown
    directory, a dense directory past 26 bits, codes of the wrong width, a
    saved table without a directory, and a saved bucket table without its
    ids."""
    packed = jcodes.random_codes(7, 100, 128)
    with pytest.raises(ValueError, match="unknown directory"):
        build_index(packed, MIHConfig(), device="cpu", directory="btree")
    with pytest.raises(ValueError, match="infeasible"):
        build_index(packed, MIHConfig(), device="cpu", directory="dense")
    with pytest.raises(ValueError):
        build_index(packed[:, :2], MIHConfig(), device="cpu")
    arrays = {"n": np.asarray(100), "bits": np.asarray(128),
              "n_tables": np.asarray(4), "codes": packed}
    with pytest.raises(ValueError, match="no directory"):
        index_from_arrays(arrays, device="cpu")
    ref = jax_build_index(packed[:, :2], MIHConfig(bits=64, n_tables=4),
                          directory="dense")
    with pytest.raises(ValueError, match="t0_ids"):
        index_from_arrays({"n": np.asarray(100), "bits": np.asarray(64),
                           "n_tables": np.asarray(4),
                           "t0_offsets": np.asarray(
                               ref.tables[0].directory.offsets)},
                          device="cpu")


@pytest.mark.parametrize("bits_w,m,kind", [(128, 4, "RangeDirectory"),
                                           (128, 8, "DenseDirectory"),
                                           (64, 4, "DenseDirectory"),
                                           (96, 4, "DenseDirectory"),
                                           (256, 8, "RangeDirectory")])
def test_default_build_picks_the_jax_directory(bits_w, m, kind):
    """build_index with default arguments picks the JAX package's
    directory (``auto``: dense up to 24-bit substrings, else range) and
    builds the same arrays."""
    packed = jcodes.clustered_codes(2, 2000, bits_w, n_clusters=10,
                                    flip_p=0.05)
    cfg = MIHConfig(bits=bits_w, n_tables=m)
    port, ref = build_index(packed, cfg, device="cpu"), jax_build_index(
        packed, cfg)
    assert type(port.tables[0].directory).__name__ == kind
    _assert_same(port, ref)


@pytest.mark.parametrize("directory,bits_w,store_codes,with_bitmap", [
    ("dense", 64, True, True), ("dense", 64, False, False),
    ("sorted", 128, True, False), ("prefix", 128, False, False),
    ("hash", 128, True, False), ("hash", 64, False, True),
    ("range", 64, True, True)])
def test_bucket_builds_save_and_load_across_packages(
        tmp_path, directory, bits_w, store_codes, with_bitmap):
    """Every table kind the JAX package's save_index writes (dense
    offsets, sorted/prefix keys, hash rows, range with a bitmap; with and
    without per-entry codes and bitmaps): the port builds the same arrays,
    and a file saved by either package loads in the other (sorted keys load
    as a prefix directory in both). Codes crossing 2^31 in every table;
    bitmaps at 16-bit substrings (one at 32 bits is 512 MB a table)."""
    packed = jcodes.clustered_codes(31, 2500, bits_w, n_clusters=20,
                                    flip_p=0.04)
    packed[:50] |= np.uint32(0x80808080)
    cfg = MIHConfig(bits=bits_w, n_tables=4)
    kw = dict(directory=directory, store_codes=store_codes,
              with_bitmap=with_bitmap)
    port = build_index(packed, cfg, device="cpu", **kw)
    ref = jax_build_index(packed, cfg, **kw)
    _assert_same(port, ref)
    for writer, idx in (("port", port), ("jax", ref)):
        path = str(tmp_path / f"{writer}.npz")
        (port_save_index if writer == "port" else save_index)(path, idx)
        _assert_same(load_index(path, device="cpu"), jax_load_index(path))
        with np.load(path) as z:
            assert {k.split("_", 1)[1] for k in z.files
                    if k.startswith("t0_")} == (
                {"ids"} | {"dense": {"offsets"}, "sorted": {"keys"},
                           "prefix": {"keys"}, "hash": {"hashrows"},
                           "range": {"se", "rows"}}[directory]
                | ({"codes"} if store_codes and directory != "range"
                   else set()) | ({"bitmap"} if with_bitmap else set()))


def test_entry_points_default_to_the_card(tmp_path):
    """Given no device, build_index, load_index and index_from_arrays run
    on the card, and raise where there is none; a tensor stays where it
    lies, and device="cpu" runs on the CPU."""
    import torch
    packed = jcodes.random_codes(8, 300, 128)
    cpu = build_index(packed, MIHConfig(), device="cpu")
    assert cpu.device.type == "cpu"
    assert build_index(bits.as_codes(packed), MIHConfig()).device.type == "cpu"
    path = str(tmp_path / "idx.npz")
    port_save_index(path, cpu)
    with np.load(path) as z:
        arrays = dict(z)
    calls = (lambda: build_index(packed, MIHConfig()),
             lambda: load_index(path), lambda: index_from_arrays(arrays))
    if torch.cuda.is_available():
        for call in calls:
            assert call().device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert load_index(path, device="cpu").device.type == "cpu"
    assert index_from_arrays(arrays, device="cpu").device.type == "cpu"
