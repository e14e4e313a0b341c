"""The per-layer metric read from the program's counters: a tiny traced
run of a scan-tier cell reports it, and a program without the counters
leaves it out."""

import pytest

from benchmark import spec
from benchmark.tests.conftest import TINY_BATCH, run_tiny

NAME = "scan_rows_per_batch"


def test_a_traced_scan_tier_cell_reads_its_scan_rows():
    out = run_tiny("verticut-100m.uniform-k10", trace=True)
    assert out["correct"]
    assert 0 < out["metrics"][NAME]["value"] <= TINY_BATCH


def test_a_program_without_counters_reads_nothing(monkeypatch):
    from verticut_tpu_torch.utils import timer
    monkeypatch.delattr(timer, "counters")
    assert spec.reader(NAME)(None) is None


@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_json(
    spec.SPEC_FILE)["workloads"]])
def test_the_metric_applies_to_the_cells_it_lists(cell):
    listed = {m["name"]: m for m in spec.load_json(
        spec.SPEC_FILE)["per_layer"]}[NAME]["workloads"]
    names = {m["name"] for m in spec.load_cell(cell).per_layer}
    assert (NAME in names) == (cell in listed)
