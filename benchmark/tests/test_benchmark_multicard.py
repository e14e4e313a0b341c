"""Whole runs of tiny cells across several ranks, on the CPU in gloo worlds
of four, through the multi-card path: the result line keeps the
contract's keys and comes out correct; the control and each fault a
multi-card cell can have, planted in the ranks under the timed path, make
it not correct; a rank that raises ends the world with a result line
inside the world's timeout; a cell the path cannot run is refused."""

import time

import pytest

from benchmark import multicard, run, spec
from benchmark.tests import multicard_faults as faults
from benchmark.tests.conftest import TINY_BATCH, tiny_cell
from benchmark.tests.test_benchmark_run import check_line

SEED = 2**31 + 23
INLINE = ("verticut-100m.neardup-k10", "inline",
          {"table": 4, "shard": 1, "query": 1})
# a table axis is 1 or n_tables (4): shard 2 x query 2 spans four ranks
COMPACT = ("synthetic-1b.neardup-k10", "compact",
           {"table": 1, "shard": 2, "query": 2})


def mesh_cell(name, layout, mesh, chips=4, depth=1):
    cell = tiny_cell(name)
    cell.config = dict(cell.config, layout=layout, mesh=mesh)
    cell.traffic = dict(cell.traffic, depth=depth)
    cell.chips = chips
    return cell


def run_world(case=INLINE, trace=False, control=None, fault=None,
              seconds=1.0):
    return multicard.run_cell(mesh_cell(*case), SEED, seconds, trace,
                              time.perf_counter(), device="cpu",
                              control=control, fault=fault)


@pytest.mark.parametrize("case,trace", [(INLINE, False), (COMPACT, True)],
                         ids=["inline-4x1x1", "compact-1x2x2-traced"])
def test_world_of_four_is_correct(case, trace):
    out = run_world(case, trace=trace)
    check_line(out, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["count"] == 4
    assert out["compared"]["rank_mismatches"]["value"] == 0
    if trace:
        assert out["metrics"]["build_s"]["value"] > 0
    else:
        assert out["metrics"]["setup_s"]["value"] > 0
        rate = [m for m in out["metrics"] if m.startswith("queries_per_s")]
        assert len(rate) == 1 and out["metrics"][rate[0]]["value"] > 0


def test_control_is_not_correct():
    out = run_world(control="tail", seconds=3.0)
    assert not out["correct"]
    assert out["compared"]["wrong_dists"]["value"] > 0


@pytest.mark.parametrize("fault", [faults.altered_rank0, faults.stale,
                                   faults.half, faults.no_exchange],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    assert not run_world(fault=fault)["correct"]


def test_a_fault_on_one_rank_alone_shows_as_a_mismatch():
    out = run_world(fault=faults.altered_rank1)
    assert not out["correct"]
    assert out["compared"]["rank_mismatches"]["value"] >= 1


def test_a_rank_that_raises_ends_the_world_with_a_result_line():
    t0 = time.perf_counter()
    out = run_world(fault=faults.raises_rank1)
    assert time.perf_counter() - t0 < multicard.WORLD_TIMEOUT.total_seconds()
    check_line(out, trace=False)
    assert not out["correct"]
    assert out["failed"] == TINY_BATCH == out["attempted"]


@pytest.mark.parametrize("chips,depth,says", [(4, 4, "depth 4"),
                                               (1, 1, "spans 4 cards")])
def test_a_cell_the_path_cannot_run_is_refused(monkeypatch, capsys, chips,
                                               depth, says):
    cell = mesh_cell(*INLINE, chips=chips, depth=depth)
    assert says in multicard.refusal(cell)
    with pytest.raises(ValueError, match=says):
        multicard.run_cell(cell, SEED, 1.0, False, time.perf_counter(),
                           device="cpu")
    monkeypatch.setattr(spec, "load_cell", lambda name: cell)
    assert run.main(["--workload", cell.name, "--seed", "1", "--seconds",
                     "1"]) == 2
    out = capsys.readouterr()
    assert says in out.err and out.out == ""
