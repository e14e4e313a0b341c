"""Shared helpers of the benchmark's CPU tests: tiny cells of the real
ones, run on the CPU with the kernels' plain versions."""

import time

import pytest
import torch

from benchmark import run, spec

TINY_CODES = 8192
TINY_BATCH = 256


def tiny_cell(name: str, n: int = TINY_CODES, batch: int = TINY_BATCH):
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, n_codes=n)
    cell.params = dict(cell.params, batch=batch)
    return cell


def run_tiny(name: str, seed: int = 2**31 + 11, seconds: float = 1.0,
             trace: bool = False, control=None) -> dict:
    return run.run_cell(tiny_cell(name), seed, seconds, trace,
                        torch.device("cpu"), control=control,
                        t_start=time.perf_counter())


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
