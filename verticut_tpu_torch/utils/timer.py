"""Named accumulating timers — the ``src/timer.h:17-35`` analog.

RAII-scoped in C++ becomes a context manager / decorator here; all scopes
with the same name accumulate into a process-global table dumped by
``show_all_timings()``. For device work, wrap the scope around a
``torch.cuda.synchronize()`` boundary or the numbers measure dispatch
only. The port's copy of ``verticut_tpu/utils/timer.py``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

_lock = threading.Lock()
_totals: Dict[str, float] = {}
_counts: Dict[str, int] = {}


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


def timings() -> Dict[str, dict]:
    with _lock:
        return {k: {"total_s": v, "count": _counts[k],
                    "mean_s": v / max(_counts[k], 1)}
                for k, v in _totals.items()}


def reset() -> None:
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
