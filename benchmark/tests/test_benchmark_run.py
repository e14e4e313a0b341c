"""Whole runs of tiny cells on the CPU: the result line keeps the
contract's keys and comes out correct; the control and each fault the
cells can have, planted under the timed path, make it not correct; the
entry point refuses to run without a card; nothing imports JAX or the
JAX package."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import spec
from benchmark.tests.conftest import run_tiny
from verticut_tpu_torch import search
from verticut_tpu_torch.search import single

CELLS = [w["name"] for w in spec.load_json(spec.SPEC_FILE)["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def check_line(out: dict, trace: bool) -> None:
    line = json.loads(json.dumps(out))
    assert KEYS <= set(line) and list(line)[-1] == "compared"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_is_correct(name):
    out = run_tiny(name)
    check_line(out, trace=False)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    rate = [m for m in out["metrics"] if m.startswith("queries_per_s")]
    assert len(rate) == 1 and out["metrics"][rate[0]]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0


def test_tiny_traced_run():
    out = run_tiny(CELLS[0], trace=True)
    check_line(out, trace=True)
    assert out["correct"]
    assert out["metrics"]["build_s"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference over all but the corpus's last 1/64 in the program's
    place."""
    out = run_tiny(name, seconds=3.0, control="tail")
    assert not out["correct"]
    assert out["compared"]["wrong_dists"]["value"] > 0


def stale(monkeypatch):
    """A step that returns its state unchanged: every batch gets the
    first batch's answers."""
    orig, first = search.mih_search_finalize, []

    def finalize(h):
        res = orig(h)
        first.append(first[0] if first else res)
        return first[-1]
    monkeypatch.setattr(search, "mih_search_finalize", finalize)


def half(monkeypatch):
    """Half of each batch left out: the rest answered in its place."""
    orig_d, orig_f = search.mih_search_dispatch, search.mih_search_finalize

    def dispatch(index, queries, scfg):
        return orig_d(index, queries[:queries.shape[0] // 2], scfg)

    def finalize(h):
        res = orig_f(h)
        return type(res)(*(torch.cat([x, x]) for x in res))
    monkeypatch.setattr(search, "mih_search_dispatch", dispatch)
    monkeypatch.setattr(search, "mih_search_finalize", finalize)


def altered(monkeypatch):
    """An answer altered where it is produced: the decoded row's first id
    moved to the next code."""
    orig = single._unpack_row

    def unpack(row, k, id_bits):
        out = orig(row, k, id_bits)
        out["ids"][:, 0] += 1
        return out
    monkeypatch.setattr(single, "_unpack_row", unpack)


def ties(monkeypatch):
    """Ties at the k-th distance broken the wrong way where they are
    produced: the decoded row's last two ids swapped where their distances
    are equal."""
    orig = single._unpack_row

    def unpack(row, k, id_bits):
        out = orig(row, k, id_bits)
        d, ids = out["dists"], out["ids"]
        tie = d[:, -1] == d[:, -2]
        a, b = ids[:, -2].clone(), ids[:, -1].clone()
        ids[:, -2] = torch.where(tie, b, a)
        ids[:, -1] = torch.where(tie, a, b)
        return out
    monkeypatch.setattr(single, "_unpack_row", unpack)


@pytest.mark.parametrize("fault", [stale, half, altered, ties])
@pytest.mark.parametrize("name", [CELLS[0], CELLS[1]])
def test_fault_is_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    assert not run_tiny(name)["correct"]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_no_module_imports_jax():
    """A fresh process that imports every module under the benchmark holds
    no module whose top-level name is jax, jaxlib, flax or verticut_tpu."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import benchmark\n"
        "from benchmark import spec\n"
        "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
        "    importlib.import_module(m.name)\n"
        "for f in os.listdir(os.path.join(spec.HERE, 'metrics')):\n"
        "    spec.reader(f[:-3])\n"
        "bad = {'jax', 'jaxlib', 'flax', 'verticut_tpu'}\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.gpu
def test_tiny_cell_on_the_card():
    """The same tiny cell, and its control, through the card's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import run
    from benchmark.tests.conftest import tiny_cell
    dev = torch.device("cuda", 0)
    for control, want in ((None, True), ("tail", False)):
        out = run.run_cell(tiny_cell(CELLS[0]), 7, 1.0, False, dev,
                           control=control)
        assert out["correct"] is want
