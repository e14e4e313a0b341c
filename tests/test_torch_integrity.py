"""verticut_tpu_torch.index.integrity against verticut_tpu.index.integrity:
equal reports (every mismatch count, tolerance 0) on clean builds of every
layout and directory and on each corruption a table can carry."""

import copy
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig
from verticut_tpu.index import build_index as jax_build_index
from verticut_tpu.index import directory as jdir
from verticut_tpu.index.integrity import check_index as jax_check_index
from verticut_tpu.index.integrity import check_table as jax_check_table
from verticut_tpu_torch import bits
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.index import directory as tdir
from verticut_tpu_torch.index.integrity import check_index, check_table

CFG = MIHConfig(bits=128, n_tables=4)


def _builds(n, seed, cfg=CFG, directory="range", **kw):
    rng = np.random.default_rng(seed)
    db = jcodes.pack_bytes(rng.integers(0, 256, (n, cfg.bits // 8),
                                        dtype=np.uint8))
    return (build_index(db, cfg, device="cpu", directory=directory, **kw),
            jax_build_index(jnp.asarray(db), cfg, directory=directory, **kw))


def _same_reports(a, b):
    keys = ("id_mismatches", "code_mismatches", "directory_mismatches", "ok")
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}


@pytest.mark.parametrize("store_codes,keep_ids", [(True, True),
                                                 (True, False),
                                                 (False, True),
                                                 (False, False)])
def test_clean_index_passes(store_codes, keep_ids):
    port, ref = _builds(3000, 1, store_codes=store_codes,
                        keep_entry_ids=keep_ids)
    got, want = check_index(port), jax_check_index(ref)
    assert got["ok"] and want["ok"] and got["n"] == 3000
    for a, b in zip(got["tables"], want["tables"], strict=True):
        _same_reports(a, b)


@pytest.mark.parametrize("directory,store_codes", [
    ("dense", True), ("dense", False), ("hash", True), ("prefix", True),
    ("sorted", True)])
def test_clean_bucket_index_passes(directory, store_codes):
    """The JAX package's directory parameter: dense at 64-bit codes
    (16-bit substrings), the others at 128."""
    cfg = MIHConfig(bits=64, n_tables=4) if directory == "dense" else CFG
    port, ref = _builds(3000, 1, cfg, directory, store_codes=store_codes)
    got, want = check_index(port), jax_check_index(ref)
    assert got["ok"] and want["ok"] and got["n"] == 3000
    for a, b in zip(got["tables"], want["tables"], strict=True):
        _same_reports(a, b)


def _flip(t, pos, mask):
    out = t.clone()
    out.reshape(-1)[pos] ^= mask
    return out


def _flip_j(a, pos, mask):
    h = np.asarray(a).copy()
    h.reshape(-1)[pos] ^= np.asarray(mask).astype(h.dtype)
    return jnp.asarray(h)


@pytest.mark.parametrize("field,pos,mask,store_codes,found", [
    ("entry_rows", 3 * 125 + 1, 1, True, "id_mismatches"),   # an id lane
    ("entry_rows", 2 * 125 + 25 + 4, 0x10000, True, "code_mismatches"),
    ("entry_idrows", 7 + 32, 3, False, "id_mismatches"),
    ("entry_ids", 11, 1, True, "id_mismatches"),
])
def test_detects_corrupted_entry(field, pos, mask, store_codes, found):
    port, ref = _builds(2000, 2, store_codes=store_codes)
    t, tj = port.tables[1], ref.tables[1]
    bad = t._replace(**{field: _flip(getattr(t, field), pos, mask)})
    bad_j = tj._replace(**{field: _flip_j(getattr(tj, field), pos, mask)})
    got = check_table(port.codes, bad, 1, CFG)
    _same_reports(got, jax_check_table(ref.codes, bad_j, 1, CFG))
    assert not got["ok"] and got[found] >= 1


def test_detects_corrupted_directory():
    port, ref = _builds(2000, 4)
    se = port.tables[0].directory.se.clone()
    nz = int(torch.nonzero(se[:, 1] - se[:, 0])[0, 0])
    se[nz, 0] += 1
    bad = port.tables[0]._replace(
        directory=tdir.RangeDirectory(se=se, s_bits=CFG.s_bits))
    bad_j = ref.tables[0]._replace(directory=jdir.RangeDirectory(
        se=jnp.asarray(se.numpy()), s_bits=CFG.s_bits))
    got = check_table(port.codes, bad, 0, CFG)
    _same_reports(got, jax_check_table(ref.codes, bad_j, 0, CFG))
    assert not got["ok"] and got["directory_mismatches"] >= 1


@pytest.mark.parametrize("directory,field,pos,mask", [
    ("dense", "offsets", 300, 1), ("sorted", "okeys", 40, 1 << 31),
    ("prefix", "okeys", 900, 2), ("prefix", "run_end", 17, 1),
    ("prefix", "prefix_offsets", 5, 1), ("hash", "rows", None, 1),
    ("dense", "entry_codes", 4 * 77 + 2, 0x100)])
def test_detects_corrupted_bucket_table(directory, field, pos, mask):
    """Each stored array of a bucket table, one word flipped, in both
    packages: equal reports, and the corruption found. A hash row is
    corrupted in the count of an occupied slot."""
    cfg = MIHConfig(bits=64, n_tables=4) if directory == "dense" else CFG
    port, ref = _builds(2000, 6, cfg, directory)
    t, tj = port.tables[2], ref.tables[2]
    if field == "entry_codes":
        bad = t._replace(entry_codes=_flip(t.entry_codes, pos, mask))
        bad_j = tj._replace(entry_codes=_flip_j(tj.entry_codes, pos, mask))
    else:
        d = copy.copy(t.directory)
        arr = getattr(d, field)
        if pos is None:                         # an occupied slot's count
            pos = 4 * int(torch.nonzero(arr[:, 2])[0, 0]) + 2
        setattr(d, field, _flip(arr, pos, mask))
        if directory == "hash":
            dj = jdir.HashDirectory(rows=jnp.asarray(bits.to_u32(d.rows)))
        elif directory == "dense":
            dj = jdir.DenseDirectory(offsets=jnp.asarray(d.offsets.numpy()))
        elif directory == "sorted":
            dj = jdir.SortedDirectory(keys=jnp.asarray(bits.to_u32(d.keys)))
        else:
            dj = jdir.PrefixDirectory(
                jnp.asarray(d.prefix_offsets.numpy()),
                jnp.asarray(bits.to_u32(d.keys)),
                jnp.asarray(d.run_end.numpy()), d.shift, d.iters)
        bad, bad_j = t._replace(directory=d), tj._replace(directory=dj)
    got = check_table(port.codes, bad, 2, cfg)
    _same_reports(got, jax_check_table(ref.codes, bad_j, 2, cfg))
    assert not got["ok"]


def test_needs_codes_and_an_id_column():
    port, _ = _builds(500, 5)
    with pytest.raises(ValueError, match="code array"):
        check_index(dataclasses.replace(port, codes=None))
    t = port.tables[0]._replace(entry_ids=None, entry_rows=None)
    with pytest.raises(ValueError, match="no id column"):
        check_table(port.codes, t, 0, CFG)
