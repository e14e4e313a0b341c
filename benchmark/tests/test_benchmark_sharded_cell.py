"""The four-card cell of upstream's one-table-per-rank deployment, its
corpus and batch cut to tiny ones, run whole on the CPU in a gloo world of
four through the multi-card path: correct on every rank, and the
collectives' metrics read as their readers say (per-layer metrics, so
under ``--trace 1`` alone); those readers read nothing where the program
counts no sharded batch, as on one card or in a program without the
counters."""

import time

import pytest

from benchmark import multicard, spec
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.test_benchmark_run import check_line

NAME = "synthetic-1b-128b-inline.neardup-k10"
SEED = 2**31 + 29
METRICS = ("collectives_per_batch", "collective_mb_per_batch")


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_the_cell_is_correct_across_four_ranks(trace):
    cell = tiny_cell(NAME)
    assert cell.chips == 4 and multicard.refusal(cell) is None
    assert set(METRICS) <= {m["name"] for m in cell.per_layer}
    out = multicard.run_cell(cell, SEED, 1.0, trace, time.perf_counter(),
                             device="cpu")
    check_line(out, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["count"] == 4
    assert out["compared"]["rank_mismatches"]["value"] == 0
    got = out["metrics"]
    if not trace:
        assert not set(METRICS) & set(got)
        assert got["queries_per_s.radius_step"]["value"] > 0
        assert got["batch_p95_ms"]["value"] > 0
        return
    # a radius step gathers its strips and sums its stats, and a batch
    # gathers its results over the query axis: three at the least
    assert got["collectives_per_batch"]["value"] >= 3
    assert got["collectives_per_batch"]["unit"] == "calls"
    assert got["collective_mb_per_batch"]["value"] > 0
    assert got["collective_mb_per_batch"]["unit"] == "MB"
    assert got["cands_per_query"]["value"] > 0


@pytest.mark.parametrize("counters", [None, {"coll.calls": 5,
                                             "coll.bytes": 640}],
                         ids=["no-counters", "no-sharded-batches"])
def test_the_readers_read_nothing_without_sharded_batches(monkeypatch,
                                                         counters):
    from verticut_tpu_torch.utils import timer
    if counters is None:
        monkeypatch.delattr(timer, "counters")
    else:
        monkeypatch.setattr(timer, "counters", lambda since=None: counters)
    for name in METRICS:
        assert spec.reader(name)(None) is None


def test_the_readers_divide_by_the_sharded_batches(monkeypatch):
    from verticut_tpu_torch.utils import timer
    monkeypatch.setattr(timer, "counters", lambda since=None: {
        "coll.calls": 30, "coll.bytes": 12_000_000,
        "mih.sharded_batches": 4})
    assert spec.reader("collectives_per_batch")(None) == 7.5
    assert spec.reader("collective_mb_per_batch")(None) == 3.0
