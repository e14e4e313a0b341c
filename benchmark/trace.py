"""The traced stretch: ``torch.profiler`` over a steady stretch of the
closed loop, reduced to what the per-layer readers and the result line
take: the device's busy intervals, kernel launches, kernel time by name,
and the idle gaps by what the driving host thread was doing.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

#: entries of each list of the result line's ``breakdown``
TOP = 10
#: characters kept of a kernel or operator name
NAME_CHARS = 160
OUTSIDE = "host_code_outside_operators"
#: the prefix of the device record the profiler puts around each NCCL
#: collective's kernel: busy time, but neither an operation nor a launch
COLLECTIVE_RANGE = "nccl:"


@dataclasses.dataclass
class Trace:
    window_s: float                   # seconds of the traced stretch
    batches: int                      # batches finalized inside it
    busy_s: float                     # union of device intervals
    launches: int                     # kernels that ran on the device
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _gap_owners(gaps: List[Tuple[int, int]], ops) -> Dict[str, float]:
    """Seconds of each gap, by the innermost host operator running at its
    middle on one thread (``ops``: ``(start, end, name)`` ns, properly
    nested), or :data:`OUTSIDE`."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    owners: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (a + b) // 2
        while j < len(ops) and ops[j][0] <= mid:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        owners[stack[-1][2] if stack else OUTSIDE] += (b - a) * 1e-9
    return owners


def reduce(events, t0: int, t1: int, batches: int) -> Trace:
    """A :class:`Trace` of the stretch ``[t0, t1]`` (ns of the profiler's
    clock, the system clock) from ``kineto_results.events()``; device
    intervals are clipped to the stretch."""
    device, host = [], defaultdict(list)
    launches = 0
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            a, b = max(start, t0), min(start + dur, t1)
            if a >= b:
                continue
            device.append((a, b))
            name = e.name()
            if name.startswith(COLLECTIVE_RANGE):
                continue
            by_name[name[:NAME_CHARS]] += (b - a) * 1e-9
            if not name.startswith(("Memcpy", "Memset")):
                launches += 1
        elif dur > 0:
            host[e.start_thread_id()].append((start, start + dur,
                                              e.name()[:NAME_CHARS]))
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    # the thread that drives the card: the one that launched the most
    driver = max(host, key=lambda t: sum(1 for o in host[t]
                                         if "LaunchKernel" in o[2]),
                 default=None)
    owners = _gap_owners(gaps, host[driver]) if driver is not None else {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(owners.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(window_s=(t1 - t0) * 1e-9, batches=batches, busy_s=busy_s,
                 launches=launches, device_ops=[list(x) for x in top],
                 idle_gaps=[list(x) for x in idle])


def traced(step: Callable[[], bool], batches: int, cuda: bool,
           settle: int) -> Trace:
    """Profile ``step`` (one turn of the closed loop; True when it
    finalized a batch) until ``batches`` batches were finalized, after
    ``settle`` turns that finalize what the loop finished, unrecorded,
    while the profiler started."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    done = 0
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(settle):
            step()
        t0 = time.time_ns()
        while done < batches:
            done += bool(step())
        t1 = time.time_ns()
    return reduce(prof.profiler.kineto_results.events(), t0, t1, done)
