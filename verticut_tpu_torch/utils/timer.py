"""Named accumulating timers — the ``src/timer.h:17-35`` analog — and the
port's spans and counters.

RAII-scoped in C++ becomes a context manager / decorator here; all scopes
with the same name accumulate into a process-global table dumped by
``show_all_timings()``. For device work, wrap the scope around a
``torch.cuda.synchronize()`` boundary or the numbers measure dispatch
only. The timers are the port's copy of ``verticut_tpu/utils/timer.py``.

:func:`span` names a stretch of the search path for ``torch.profiler``:
a host range while a profiler records and a shared no-op otherwise, so
tracing is on exactly while a profiler records. :func:`count` adds host
integers the code already holds to a process-wide counter table;
:func:`counters` reads it, whole or as the change since an earlier
reading, and :func:`held_counts` adds a block's counts all at once.
Counters never read the device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch.autograd.profiler as _profiler
from torch._C import _profiler as _ranges

_lock = threading.Lock()
_totals: Dict[str, float] = {}
_counts: Dict[str, int] = {}
_counters: Dict[str, int] = {}
_NO_SPAN = contextlib.nullcontext()
_held = threading.local()


class Timer:
    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        with _lock:
            _totals[self.name] = _totals.get(self.name, 0.0) + dt
            _counts[self.name] = _counts.get(self.name, 0) + 1
        return False


def scoped(name: str):
    """Decorator form."""
    def wrap(fn):
        def inner(*a, **kw):
            with Timer(name):
                return fn(*a, **kw)
        return inner
    return wrap


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else one
    shared no-op context: a span costs one flag read when nothing
    records. The range has the operators' scope, not a user
    annotation's, so the profiler leaves no record of it on the device:
    the device's records stay the kernels and copies alone."""
    if _profiler._is_profiler_enabled:
        return _ranges._RecordFunctionFast(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (inside :func:`held_counts`, to
    the block's held counts)."""
    held = getattr(_held, "counts", None)
    if held is not None:
        held[name] = held.get(name, 0) + n
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def held_counts():
    """Hold this thread's counts until the block ends, then add them all
    under one lock: a reading of :func:`counters` holds all of a block's
    counts or none. A block that raises adds nothing."""
    outer = getattr(_held, "counts", None)
    _held.counts = mine = {}
    try:
        yield
    finally:
        _held.counts = outer
    if outer is not None:
        for k, v in mine.items():
            outer[k] = outer.get(k, 0) + v
        return
    with _lock:
        for k, v in mine.items():
            _counters[k] = _counters.get(k, 0) + v


def counters(since: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """A copy of the counter table; with ``since`` (an earlier reading),
    what each counter added after it."""
    with _lock:
        now = dict(_counters)
    if since is None:
        return now
    return {k: v - since.get(k, 0) for k, v in now.items()}


def timings() -> Dict[str, dict]:
    with _lock:
        return {k: {"total_s": v, "count": _counts[k],
                    "mean_s": v / max(_counts[k], 1)}
                for k, v in _totals.items()}


def reset() -> None:
    """Clear the timers; the counters keep counting."""
    with _lock:
        _totals.clear()
        _counts.clear()


def show_all_timings() -> str:
    lines = ["===== timings ====="]
    for name, t in sorted(timings().items()):
        lines.append(f"{name:30s} total {t['total_s']:9.4f}s  "
                     f"n={t['count']:<7d} mean {t['mean_s']*1e3:9.3f}ms")
    out = "\n".join(lines)
    print(out)
    return out
