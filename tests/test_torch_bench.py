"""The port's benchmark, oracle drive and time breakdown
(verticut_tpu_torch.bench, .oracle_drive, .breakdown) at a small size on
the CPU: their cell functions run end to end and every oracle check
passes; their queries are the reference bench's; their entry points
refuse to run without CUDA."""

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
def test_bench_runs_on_cpu(device_build_min):
    """Both branches of the corpus (made on the device, and on the host),
    the headline pipeline, the oracle cell, the k = 100 and uniform
    cells."""
    rec = bench.run(20_000, 256, 10, CPU, oracle_nq=64, cells=True,
                    device_build_min=device_build_min, n_batches=4,
                    latency_runs=1)
    x = rec["extra"]
    assert rec["metric"] == "mih_exact_qps_per_chip" and rec["value"] > 0
    assert bench.oracle_ok(x) and x["oracle_queries"] == 64
    assert x["layout"] == "inline" and x["n_codes"] == 20_000
    assert x["k100_qps"] > 0 and x["uniform_q_qps"] > 0
    assert x["uniform_mean_radius"] >= 1


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
    assert rec["blockmin"] == {"tensor": 0, "generic": 0}


def test_union_of_intervals():
    assert breakdown._union([]) == 0
    assert breakdown._union([(5, 7), (0, 2), (1, 3), (6, 9), (9, 9)]) == 7


@pytest.mark.parametrize("module", ["verticut_tpu_torch.bench",
                                    "verticut_tpu_torch.oracle_drive",
                                    "chip_smoke",
                                    "verticut_tpu_torch.breakdown"])
def test_entry_points_refuse_to_run_without_cuda(module):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "is_available() is False" in proc.stderr
    assert proc.stdout == ""
