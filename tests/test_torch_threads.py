"""What the port's dispatch workers share across threads: the kernels'
launch counts, the search path's counters and the native-library build. Each is driven from more
threads than this machine has cores, with a short switch interval, and
checked for a lost update or a second build."""

import ctypes
import os
import subprocess
import sys
import threading

import pytest

from verticut_tpu_torch.kernels import _build
from verticut_tpu_torch.kernels import blockmin as kb
from verticut_tpu_torch.kernels import pairwise as kp

THREADS = 4 * (os.cpu_count() or 1)


def _hammer(fn, n_calls):
    """``fn()`` ``n_calls`` times on each of THREADS threads at once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        go = threading.Barrier(THREADS)

        def run():
            go.wait(timeout=60)
            for _ in range(n_calls):
                fn()

        ts = [threading.Thread(target=run) for _ in range(THREADS)]
        [t.start() for t in ts]
        [t.join(timeout=120) for t in ts]
        assert not any(t.is_alive() for t in ts), "a thread hung"
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("module,count", [(kb, lambda: kb._count("tensor")),
                                          (kp, lambda: kp._count())])
def test_launch_counts_lose_no_update(monkeypatch, module, count):
    monkeypatch.setattr(module, "launches", 0)
    if module is kb:
        monkeypatch.setattr(kb, "launches_by_instance",
                            dict.fromkeys(kb.INSTANCES, 0))
    _hammer(count, 2000)
    assert module.launches == THREADS * 2000
    if module is kb:
        assert kb.launches_by_instance == {"tensor": THREADS * 2000,
                                           "generic": 0}


def test_concurrent_first_loads_build_once(monkeypatch, tmp_path):
    """Threads of one process share a pid, and so the build's temporary
    file: their first loads of one library must build it once and all get
    the same handle (the host library here; the CUDA ones go the same
    way on the card)."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    builds, run = [], subprocess.run

    def counted(cmd, *a, **kw):
        builds.append(cmd)
        return run(cmd, *a, **kw)

    monkeypatch.setattr(_build.subprocess, "run", counted)
    entries = {"vt_build_hashdir": (ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_uint64, ctypes.c_void_p)}
    libs, lock = [], threading.Lock()

    def load():
        lib = _build.load("hashdir", entries)
        with lock:
            libs.append(lib)

    _hammer(load, 1)
    assert len(builds) == 1
    assert len(libs) == THREADS and all(lib is libs[0] for lib in libs)
    assert os.listdir(tmp_path) == ["libvt_hashdir.so"]


def test_counters_lose_no_update():
    """The dispatch worker and its callers add to one counter table."""
    from verticut_tpu_torch.utils import timer
    before = timer.counters()
    _hammer(lambda: timer.count("test.threads.hammer", 3), 2000)
    assert (timer.counters(since=before)["test.threads.hammer"]
            == 3 * THREADS * 2000)
