"""BENCHMARK.json and the cell files: every cell resolves to its files by
name, and every name, unit, source and key keeps to the benchmark
contract's rules."""

import json
import os
import re

import pytest

from benchmark import spec

SPEC = spec.load_json(spec.SPEC_FILE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(spec.SPEC_FILE) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["name"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(CELLS)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])


def test_metrics():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and line(m["layer"])
        layers.add(m["layer"])
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    """Config, traffic and cell files, and a reader for every metric the
    cell reports; every cell reports setup_s, another end-to-end metric and
    a per-layer one, and each per-layer metric beside the one it moves."""
    cell = spec.load_cell(name)
    assert cell.config and cell.traffic and cell.batch > 0
    for m in cell.end_to_end + cell.per_layer:
        assert os.path.isfile(spec.metric_file(m["name"]))
        assert callable(spec.reader(m["name"]))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)


def test_every_per_layer_metric_with_workloads_reports_in_them():
    for m in SPEC["per_layer"]:
        for w in m.get("workloads", []):
            assert m["name"] in {x["name"] for x in
                                 spec.load_cell(w).per_layer}


def test_data_files_are_named_from_names():
    for kind in ("configs", "traffic", "cells"):
        for f in os.listdir(os.path.join(spec.HERE, kind)):
            assert f.endswith(".json") and NAME.match(f[:-5])
            json.loads(open(os.path.join(spec.HERE, kind, f)).read())


def test_a_mesh_spans_its_cells_chips():
    """A configuration that names a mesh runs across T * S * Q cards: as
    many as each of its cells asks for."""
    for w in SPEC["workloads"]:
        cfg = spec.load_json(spec.data_file("configs", w["config"]))
        if "mesh" in cfg:
            m = cfg["mesh"]
            assert set(m) == {"table", "shard", "query"}
            assert m["table"] * m["shard"] * m["query"] == w["chips"]
