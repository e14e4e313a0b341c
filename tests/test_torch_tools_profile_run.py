"""The port's profiling and measurement tools run end to end on the CPU
(``--device cpu``, small sizes), against the JAX tools.

* JSON shape: each tool's ``"metric"`` and row names are the JAX tool's
  (its committed artifact's keys where there is one, else the names its
  source builds), with the measured sizes in the names normalised and the
  rows the port leaves out named in its ``left_out``.
* Formulation checks: every equality check a tool makes holds (each
  timed formulation against the production path's answer).
* Tool parity: ``virtual_scale_run --device cpu`` (8 gloo ranks, a
  (4, 2, 1) mesh) and ``compact_chip_bench --device cpu`` give the same
  deterministic fields as the JAX tools, run in subprocesses on the CPU
  (started together when the module's first test asks for one) on the
  same N: ``memory_stats``, ``mean_radius``, the oracle and load
  equalities and ``ok``. The JAX compact bench fixes its batch at 8192
  queries, so the port's runs at 8192 too.
"""

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from verticut_tpu_torch.tools import (
    compact_chip_bench, gather_bench, int8_scan_bench, microbench_r5,
    pipeline_overlap_bench, profile_fused_ablate, profile_scan,
    profile_stages, profile_stages2, profile_tiers, qscale_bench,
    virtual_scale_run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COMPACT = 100_000
N_SCALE = 200_000

JAX_RUNS = {
    "compact_chip_bench": [str(N_COMPACT), "jax_compact.json"],
    "virtual_scale_run": [str(N_SCALE), "jax_scale.json"],
}


def _jax_tool(tmp, tool, args):
    """The JAX tool's artifact, from a run in a subprocess on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               VERTICUT_JAX_CACHE=os.path.join(tmp, "jax_cache"),
               VERTICUT_SCALE_SAVE=os.path.join(tmp, "jax_scale_idx"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{tool}.py"), *args],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(tmp, args[1])) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tools_profile"))


@pytest.fixture(scope="module")
def jax_runs(tmp):
    with ThreadPoolExecutor(len(JAX_RUNS)) as ex:
        yield {k: ex.submit(_jax_tool, tmp, k, v)
               for k, v in JAX_RUNS.items()}


SMALL = ["--device", "cpu"]
#: each tool's argv at a CPU size
ARGS = {
    "profile_stages": ["--n", "20000", "--q", "128", "--reps", "1"],
    "profile_stages2": ["--n", "20000", "--q", "128", "--r", "2"],
    "profile_tiers": ["--n", "20000", "--q", "128", "--reps", "1"],
    "profile_fused_ablate": ["--n", "20000", "--q", "64", "--r", "2"],
    "qscale_bench": ["--n", "20000", "--qs", "64", "--depths", "4", "6", "8",
                     "--batches", "2"],
    "pipeline_overlap_bench": ["--n", "20000", "--q", "64"],
    "profile_scan": ["16000", "10", "--q", "64"],
    "int8_scan_bench": ["16000", "--q", "64"],
    "gather_bench": ["--n", "40000", "--qc", "64x16", "32x8"],
    "microbench_r5": ["--n", "20000", "--q", "64"],
    "compact_chip_bench": [str(N_COMPACT), "{tmp}/port_compact.json"],
    "virtual_scale_run": [str(N_SCALE), "{tmp}/port_scale.json"],
}
MODULES = {m.__name__.rsplit(".", 1)[-1]: m for m in (
    profile_stages, profile_stages2, profile_tiers, profile_fused_ablate,
    qscale_bench, pipeline_overlap_bench, profile_scan, int8_scan_bench,
    gather_bench, microbench_r5, compact_chip_bench, virtual_scale_run)}

_recs = {}


def _port(tool, tmp):
    """The tool's record from ``main([...])`` on the CPU, once per tool."""
    if tool not in _recs:
        _recs[tool] = MODULES[tool].main(
            [a.format(tmp=tmp) for a in ARGS[tool]] + SMALL)
    return _recs[tool]


def _artifact(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _tags(keys):
    """Stage tags and batch sizes in row names normalised away."""
    return sorted({re.sub(r"s(\d)\[[^\]]*\]", r"s\1[]",
                          re.sub(r" q\d+ ", " q ", k)) for k in keys})


def _expected(tool):
    """(metric, row names) of the JAX tool, minus what the port leaves out
    (its ``left_out`` names the same rows)."""
    ks = (10, 100)
    if tool == "profile_stages2":
        art = _artifact("PROFILE_STAGES2_r05.json")
        return art["metric"], _tags(k for k in art["ms"]
                                    if "unified merge" not in k)
    if tool == "profile_stages":
        # tools/profile_stages.py:90-155
        comp = ["range_lookup x4", "chunk_descriptors x4", "fetch_score x4"]
        comp += [f"strips+merge k={k}" for k in ks]
        return "profile_stages", _tags(
            [f"s{s}[] {c}" for s in (1, 2) for c in comp]
            + [f"{n} k={k}" for k in ks for n in ("full", "r<=1-only")])
    if tool == "profile_tiers":
        # tools/profile_tiers.py:84, 95-98
        return "profile_tiers", sorted(
            f"k={k} retry={r} scan={s}" for k in ks
            for r, s in ((1, 1), (0, 1), (1, 0), (0, 0)))
    if tool == "profile_fused_ablate":
        art = _artifact("PROFILE_ABLATE_r05.json")
        return art["metric"], sorted(art["ms"])
    if tool == "qscale_bench":
        art = _artifact("QSCALE_r05.json")
        return art["metric"], _tags(art["ms"])
    if tool == "pipeline_overlap_bench":
        art = _artifact("PROFILE_OVERLAP_r04.json")
        return art["metric"], sorted(k for k in art["ms"] if "+async" not in k)
    if tool == "profile_scan":
        art = _artifact("PROFILE_SCAN_r04.json")
        acc = {"bf16": "tensor", "int8": "generic"}
        rows = [re.sub(r"_(bf16|int8)_", lambda m: f"_{acc[m[1]]}_", k)
                for k in art if k.endswith("_ms")
                and not k.startswith(("widerow", "bf16_mac"))]
        return "profile_scan", sorted(rows)
    if tool == "int8_scan_bench":
        # tools/int8_scan_bench.py:35-51, acc -> instance
        return "int8_scan_bench", sorted(
            f"block{b}_{i}" for b in (128, 512) for i in ("tensor", "generic"))
    if tool == "gather_bench":
        # tools/gather_bench.py:64-122 at the test's (Q, C), blocks 128 and
        # 512, minus the transposed slices
        return "gather_bench", sorted(
            [f"[{qc}] rowmajor ({b},4) slices" for qc in ("64x16", "32x8")
             for b in (128, 512)] + [f"[{qc}] row gather"
                                     for qc in ("64x16", "32x8")])
    if tool == "microbench_r5":
        # tools/microbench_r5.py:127-164, minus the dbt gathers
        rows = [f"rescore_k{k}_b{b}_{f}_ms"
                for k, b in ((10, 512), (100, 128), (100, 512))
                for f in ("slice", "rows")]
        for c, p, ds in ((1100, 100, (2, 4, 5)), (5800, 100, (8, 10, 25)),
                         (1100, 10, (10, 25)), (2200, 10, (10, 22, 25)),
                         (8192, 100, (8, 16, 32))):
            rows.append(f"sel_c{c}_p{p}_native_ms")
            rows += [f"sel_c{c}_p{p}_cm{d}_ms" for d in ds if c % d == 0]
        return "microbench_r5", sorted(rows)
    if tool == "compact_chip_bench":
        art = _artifact("BENCH_100M_COMPACT_r05.json")
        return art["metric"], sorted(art)
    art = _artifact("VIRTUAL_SCALE_r04.json")
    return art["metric"], sorted(art)


def _rows(tool, rec):
    if tool in ("profile_scan", "microbench_r5"):
        return sorted(k for k in rec if k.endswith("_ms")
                      and k != "bound_ms")
    if tool == "gather_bench":
        return sorted(rec["res"])
    if tool == "compact_chip_bench":
        return sorted(k for k in rec if k != "planted_found")
    if tool == "virtual_scale_run":
        return sorted(rec)
    keys = rec["ms"]
    return _tags(keys) if tool in ("profile_stages", "profile_stages2",
                                   "qscale_bench") else sorted(keys)


@pytest.mark.parametrize("tool", list(ARGS))
def test_json_shape_is_the_jax_tools(tool, tmp):
    rec = _port(tool, tmp)
    metric, rows = _expected(tool)
    assert rec["metric"] == metric
    assert _rows(tool, rec) == rows
    if tool in ("profile_stages2", "pipeline_overlap_bench", "profile_scan",
                "gather_bench", "microbench_r5"):
        assert rec["left_out"] and all(rec["left_out"].values())


@pytest.mark.parametrize("tool", [t for t in ARGS if t not in (
    "compact_chip_bench", "virtual_scale_run", "int8_scan_bench")])
def test_every_formulation_check_holds(tool, tmp):
    rec = _port(tool, tmp)
    if tool == "profile_stages2":
        assert rec["checks"] == {}       # components only: nothing to hold
        return
    assert rec["checks"] and all(rec["checks"].values()), rec["checks"]


def test_int8_scan_bench_instances_agree(tmp):
    rec = _port("int8_scan_bench", tmp)
    assert rec["distances_equal"] and rec["ids_equal"]


@pytest.mark.parametrize("tool", ["profile_stages", "profile_stages2"])
def test_component_profiles_cover_every_row(tool, tmp):
    """Each component row carries its profiled call (no device on the
    CPU: no launches, no device time)."""
    rec = _port(tool, tmp)
    assert set(rec["profile"]) == set(rec["ms"])
    assert all(p["launches"] == 0 and p["device_ms"] is None
               for p in rec["profile"].values())


@pytest.mark.parametrize("tool", ["compact_chip_bench", "virtual_scale_run"])
def test_tool_matches_the_jax_tool(tool, tmp, jax_runs):
    got = _port(tool, tmp)
    want = jax_runs[tool].result()
    eq = ("oracle_multiset_equal", "load_multiset_equal")
    for f in ("memory_stats", "mean_radius", "ok", "n", "mesh", "k") + eq:
        if f in want:
            assert got[f] == want[f], f
    assert got["ok"] is True
    with open(ARGS[tool][1].format(tmp=tmp)) as f:
        assert json.load(f) == got           # the artifact is the record
