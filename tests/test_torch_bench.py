"""The tools' bench helpers, oracle drive and time breakdown
(verticut_tpu_torch.bench, .oracle_drive, .breakdown) at a small size on
the CPU: their cell functions run end to end and every oracle check
passes; their queries are the reference bench's; the entry points refuse
to run without CUDA."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from verticut_tpu import codes as jcodes
from verticut_tpu_torch import bench, bits, breakdown, oracle_drive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """The cells run thousands of tiny ops; one intra-op thread keeps them
    from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_perturbed_queries_are_the_reference_bench_queries():
    """The reference's host branch flips bytes of unpacked codes, its
    device branch XORs packed words; both from the same numpy draws, and
    so does the port, on either device."""
    packed = jcodes.random_codes(1, 5000, 128)
    rng = np.random.default_rng(0)
    sel = rng.integers(0, len(packed), 300)
    qraw = jcodes.unpack_to_bytes(packed[sel])
    for i, row in enumerate(rng.integers(0, 128, (300, 3))):
        for b in row:
            qraw[i, b // 8] ^= 1 << (b % 8)
    got = bench.perturbed_queries(np.random.default_rng(0),
                                  bits.as_codes(packed), 300)
    assert np.array_equal(bits.to_u32(got), jcodes.pack_bytes(qraw))


@pytest.mark.parametrize("device_build_min", [10_000, bench.DEVICE_BUILD_MIN])
def test_make_index_serves_a_cell_equal_to_the_oracle(device_build_min):
    """Both branches of the corpus (made on the device, and on the host):
    the index, a cell's single and pipelined batches, and its answers
    held to the popcount oracle in dists and ids."""
    from verticut_tpu_torch.config import SearchConfig
    index, info = bench.make_index(20_000, CPU, device_build_min)
    assert info["layout"] == "inline" and index.n == 20_000
    assert info["gen_s"] > 0 and info["build_s"] > 0
    q = bench.perturbed_queries(np.random.default_rng(0), index.codes, 256)
    scfg = SearchConfig(candidate_cap=8192, max_enum_radius=5)
    c = bench.cell(index, q, scfg, n_batches=4, latency_runs=1)
    assert c["qps"] > 0 and c["handle"].packed.shape == (256, 13)
    assert bool((c["result"].dists[:, 0] <= 3).all())
    rec = bench.oracle_check(index, q, scfg, c["result"])
    assert bench.oracle_ok(rec) and rec["oracle_queries"] == 256


def test_pipelined_declines_a_loop_request():
    index, _ = bench.make_index(3000, CPU)
    q = bench.perturbed_queries(np.random.default_rng(1), index.codes, 64)
    from verticut_tpu_torch.config import SearchConfig
    assert bench.pipelined(index, q, SearchConfig(fused=False), 4) is None
    sec, res, handle = bench.pipelined(index, q, SearchConfig(), 5)
    assert sec > 0 and handle.packed.shape == (64, 13)
    assert bench.oracle_ok(bench.oracle_check(index, q, SearchConfig(), res))


def test_oracle_drive_cells_pass_on_cpu():
    cells = oracle_drive.run_cells(20_000, 256, (10, 500), CPU)
    assert [(c["corpus"], c["k"]) for c in cells] == [
        ("clustered", 10), ("clustered", 500), ("uniform", 10),
        ("uniform", 500)]
    assert all(c["ok"] for c in cells), cells


def test_breakdown_cell_on_cpu():
    """One profiled batch beside three unprofiled ones; on the CPU the
    profile holds no device interval, so device time is None."""
    from verticut_tpu_torch.config import SearchConfig
    index, _ = bench.make_index(3000, CPU)
    q = bench.perturbed_queries(np.random.default_rng(2), index.codes, 64)
    rec = breakdown.profile_cell(index, q, SearchConfig())
    assert len(rec["walls_s"]) == 3 and rec["wall_s"] > 0
    assert rec["device_s"] is None and rec["idle"] is None
    assert rec["kernels"] == 0 and rec["top"] == []
    assert rec["launch_cpu_s"] == rec["sync_cpu_s"] == 0
    assert rec["blockmin"] == {"tensor": 0, "generic": 0}
    assert rec["fetch_score"] == 0


def test_breakdown_pair_on_cpu():
    """Two batches back to back against two handles in flight, timed in
    turns and profiled, every result checked; on the CPU there are no
    device intervals."""
    from verticut_tpu_torch.config import SearchConfig
    from verticut_tpu_torch.search import mih_search
    index, _ = bench.make_index(3000, CPU)
    q = bench.perturbed_queries(np.random.default_rng(3), index.codes, 64)
    want, seen = mih_search(index, q, SearchConfig()), []

    def check(mode, res):
        seen.append(mode)
        assert all(torch.equal(getattr(res, f), getattr(want, f))
                   for f in want._fields), mode

    rec = breakdown.profile_pair(index, q, SearchConfig(), reps=2,
                                 check=check)
    assert set(rec) == {"back_to_back", "in_flight"}
    # a warm-up, two timed runs and a profiled one, two batches each
    assert seen.count("back_to_back") == seen.count("in_flight") == 8
    assert 0 < rec["in_flight"]["dispatch_s"]
    for mode in rec.values():
        assert len(mode["runs_s"]) == 2 and mode["batch_s"] > 0
        assert mode["kernels"] == 0
        assert mode["device_s"] is None and mode["concurrent_s"] is None


def test_union_of_intervals():
    assert breakdown._union([]) == 0
    assert breakdown._union([(5, 7), (0, 2), (1, 3), (6, 9), (9, 9)]) == 7


@pytest.mark.parametrize("module", ["verticut_tpu_torch.oracle_drive",
                                    "chip_smoke",
                                    "verticut_tpu_torch.breakdown"])
def test_entry_points_refuse_to_run_without_cuda(module):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "is_available() is False" in proc.stderr
    assert proc.stdout == ""
