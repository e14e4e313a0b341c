"""verticut_tpu_torch.kernels.fetch_score on the CPU: the plain twins of
both row layouts against the JAX package's ``fetch_score_blocks`` and a
scalar scorer (exact equality), the wrapper's operand checks, the kernel
route of CUDA tensors (a stubbed library records the launch; the twin is
never taken), and ``ops/chunks`` handing each layout to its entry.

The CUDA route is reached here through tensors that report a CUDA device
(:class:`_OnCard`); the kernel itself runs only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import contextlib
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fetch_score_cases as cases
from verticut_tpu.ops import chunks as jchunks
from verticut_tpu_torch.kernels import fetch_score as kf
from verticut_tpu_torch.ops import chunks as tchunks
from verticut_tpu_torch.utils import timer

WIDTHS = (2, 4, 8)
TWINS = {"inline": kf.fetch_score_blocks_reference,
         "compact": kf.fetch_score_idrows_reference}
ENTRIES = {"inline": "fetch_score_blocks", "compact": "fetch_score_idrows"}


def _jax_reference(case):
    """The JAX package's ``fetch_score_blocks``; for the compact layout
    over the word-major rows that hold each id's code (clipped to the
    codes, as the JAX compact branch gathers it)."""
    rows = case.rows
    if case.layout == "compact":
        nb, blk = rows.shape
        code = case.codes[np.clip(rows, 0, len(case.codes) - 1)]
        rows = np.concatenate([rows[..., None], code], axis=-1).transpose(
            0, 2, 1).reshape(nb, -1)
    d, i = jchunks.fetch_score_blocks(
        jnp.asarray(rows.view(np.uint32)), jnp.asarray(case.blk_id),
        jnp.asarray(case.lo), jnp.asarray(case.hi),
        jnp.asarray(case.queries.view(np.uint32)), blk=case.blk)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("layout", cases.LAYOUTS)
@pytest.mark.parametrize("want", ["jax", "scalar"])
def test_twin_matches(layout, w, want):
    case = cases.make(layout, w, seed=10 * w + len(layout))
    d, i = cases.run(case, TWINS[layout])
    wd, wi = _jax_reference(case) if want == "jax" else cases.scalar(case)
    assert np.array_equal(d.numpy(), wd) and np.array_equal(i.numpy(), wi)
    # the hand-set slots: the empty and inverted windows score nothing, the
    # pad block nothing, and some slot of every case is valid
    blk = case.blk
    assert (i[:, :2 * blk] == -1).all() and (i[:, -blk:] == -1).all()
    assert (d[i == -1] == 0x7FFFFFFF).all() and (i >= 0).any()


@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_entry_on_cpu_takes_the_twin(layout):
    case = cases.make(layout, 4, seed=1)
    before = kf.launches
    got = cases.run(case, getattr(kf, ENTRIES[layout]))
    want = cases.run(case, TWINS[layout])
    assert kf.launches == before
    assert all(torch.equal(g, x) for g, x in zip(got, want, strict=True))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper takes the
    kernel route; its memory stays on the CPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


class _Lib:
    """A stand-in for the kernel library: records each entry's call and
    returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, entry):
        if not entry.startswith("vt_fetch_score_"):
            raise AttributeError(entry)
        return lambda *a: self.calls.append((entry, a)) or self.err

    def vt_error_string(self, err):
        return b"stub launch error"


@pytest.fixture
def stub_card(monkeypatch):
    """The kernel route without a card: the library stubbed, the CUDA
    device and stream calls made no-ops, and both twins raising."""
    lib = _Lib()
    monkeypatch.setattr(kf, "_load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())

    def twin(*a, **kw):
        raise AssertionError("a CUDA tensor took the plain twin")

    for name in TWINS.values():
        monkeypatch.setattr(kf, name.__name__, twin)
    return lib


def _card_case(layout, w=4):
    case = cases.make(layout, w, seed=5)
    return case, [_on_card(t) for t in case.tensors()]


@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_cuda_tensors_launch_the_kernel(stub_card, layout):
    case, t = _card_case(layout)
    before, counted = kf.launches, timer.counters()
    entry = getattr(kf, ENTRIES[layout])
    dist, ids = entry(*t) if layout == "compact" else entry(*t, blk=case.blk)
    assert kf.launches == before + 1
    assert timer.counters(since=counted)["mih.fetch_score_launches"] == 1
    (name, args), = stub_card.calls
    nq, chb = case.blk_id.shape
    assert dist.shape == ids.shape == (nq, chb * case.blk)
    assert dist.dtype == ids.dtype == torch.int32
    rows, blk_id, lo, hi, q = (t[0], *t[-4:])
    if layout == "inline":
        assert name == "vt_fetch_score_rows"
        assert args == (rows.data_ptr(), rows.shape[0], case.blk,
                        blk_id.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                        q.data_ptr(), dist.data_ptr(), ids.data_ptr(), nq,
                        chb, 4, 7)
    else:
        codes = t[1]
        assert name == "vt_fetch_score_idrows"
        assert args == (rows.data_ptr(), rows.shape[0], case.blk,
                        codes.data_ptr(), codes.shape[0], blk_id.data_ptr(),
                        lo.data_ptr(), hi.data_ptr(), q.data_ptr(),
                        dist.data_ptr(), ids.data_ptr(), nq, chb, 4, 7)


@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_cuda_launch_error_raises(stub_card, layout):
    stub_card.err = 1
    case, t = _card_case(layout)
    before = kf.launches
    entry = getattr(kf, ENTRIES[layout])
    with pytest.raises(RuntimeError, match="stub launch error"):
        entry(*t) if layout == "compact" else entry(*t, blk=case.blk)
    assert kf.launches == before


def _bad(layout, what):
    """The case's tensors with one operand made wrong in the way ``what``
    names; the kernel route where ``what`` needs it."""
    case = cases.make(layout, 4, seed=2)
    t = case.tensors()
    kw = {} if layout == "compact" else {"blk": case.blk}
    i_blk, i_q = len(t) - 4, len(t) - 1
    if what == "dtype":
        t[i_blk] = t[i_blk].long()
    elif what == "device":
        t = [_on_card(x) for x in t]
        t[i_q] = t[i_q].as_subclass(torch.Tensor)
    elif what == "noncontiguous":
        t = [_on_card(x) for x in t]
        q = t[i_q]
        t[i_q] = _on_card(torch.cat([q, q], 1).as_subclass(
            torch.Tensor)[:, ::2])
    elif what == "lo_shape":
        t[i_blk + 1] = t[i_blk + 1][:, :-1]
    elif what == "query_rows":
        t[i_q] = t[i_q][:-1]
    elif what == "lanes":
        if layout == "inline":
            kw["blk"] = case.blk + 1
        else:
            t[1] = t[1][:, :3]                  # codes of another width
    elif what == "wide":
        t = [_on_card(x) for x in t]
        t[i_q] = _on_card(torch.zeros((t[i_q].shape[0], 9),
                                      dtype=torch.int32))
        if layout == "compact":
            t[1] = _on_card(torch.zeros((5, 9), dtype=torch.int32))
        else:
            t[0] = _on_card(torch.zeros((5, 12 * 10), dtype=torch.int32))
            kw["blk"] = 12
    elif what == "empty_table":
        t = [_on_card(x) for x in t]
        t[0] = _on_card(t[0].as_subclass(torch.Tensor)[:0])
    return getattr(kf, ENTRIES[layout]), t, kw


@pytest.mark.parametrize("what,err,match", [
    ("dtype", TypeError, "int32"), ("device", ValueError, "one device"),
    ("noncontiguous", ValueError, "contiguous"),
    ("lo_shape", ValueError, "blk_id / lo / hi"),
    ("query_rows", ValueError, "blk_id / lo / hi"),
    ("lanes", ValueError, "rows|codes"), ("wide", ValueError, "W=9"),
    ("empty_table", ValueError, "empty table")])
@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_wrapper_rejects(stub_card, layout, what, err, match):
    entry, t, kw = _bad(layout, what)
    with pytest.raises(err, match=match):
        entry(*t, **kw)
    assert stub_card.calls == []


@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_chunks_routes_each_layout_to_its_entry(monkeypatch, layout):
    seen = []
    for name in ENTRIES.values():
        monkeypatch.setattr(kf, name, lambda *a, _n=name, **kw:
                            seen.append((_n, len(a), kw)) or ("d", "i"))
    case = cases.make(layout, 4, seed=3)
    got = cases.run(case, getattr(tchunks, ENTRIES[layout]))
    assert got == ("d", "i")
    n_args = 6 if layout == "compact" else 5
    kw = {} if layout == "compact" else {"blk": case.blk}
    assert seen == [(ENTRIES[layout], n_args, kw)]


def test_ctypes_signatures_match_the_c_entries(monkeypatch):
    """The argument types ``_load`` declares match the C entries of
    ``csrc/fetch_score.cu`` parameter by parameter: a pointer as
    ``c_void_p``, ``long long`` as ``c_longlong``, ``int`` as ``c_int``."""
    declared = {}
    monkeypatch.setattr(kf._build, "load",
                        lambda name, entries, restypes=None:
                        declared.update(entries))
    kf._load()
    with open(kf.SOURCE) as f:
        src = f.read()
    c_type = {"long long": ctypes.c_longlong, "int": ctypes.c_int}
    for entry in ("vt_fetch_score_rows", "vt_fetch_score_idrows"):
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)[1]
        want = [ctypes.c_void_p if "*" in p
                else c_type[" ".join(p.split()[:-1])]
                for p in params.split(",")]
        assert list(declared[entry]) == want, entry
