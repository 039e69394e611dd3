"""The traced slice of a ``--trace 1`` run: one ``torch.profiler`` session
over the first units of the window (a second session in one process misses
the kernels of the program's ctypes-loaded library), reduced to device
intervals, the device's busy time, the operations that took most of it,
and the longest idle gaps labelled by what the host was doing."""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter

import numpy as np
import torch

MARK = "perfbench.slice"


def union_length(spans):
    """The length of the union of ``(start, end)`` intervals (a stream's
    kernels and copies may overlap those of another; ``bench_torch.py``'s,
    copied)."""
    busy, end = 0.0, -np.inf
    for a0, a1 in sorted(spans):
        if a1 > end:
            busy += a1 - max(a0, end)
            end = a1
    return busy


def merged(spans):
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out = []
    for a0, a1 in sorted(spans):
        if out and a0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], a1)
        else:
            out.append([a0, a1])
    return out


# Host events of the profiler itself, never what the program was doing.
PROFILER_OPS = ("Activity Buffer Request", "ProfilerStep")


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, namespace and argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


@dataclass
class TraceData:
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    host: list = field(default_factory=list)  # (name, start_us, end_us) CPU ops
    window_us: float = 0.0  # the slice's wall time
    start_us: float = 0.0  # the slice's start on the profiler's clock
    end_us: float = 0.0
    solves: list = field(default_factory=list)  # what the kind records of the slice's solves

    @property
    def busy_us(self) -> float:
        return union_length([(a, b) for _, a, b in self.device])

    def time_of(self, keys) -> float:
        """Device seconds of the kernels whose names hold one of ``keys``."""
        return sum(b - a for n, a, b in self.device if any(k in n for k in keys)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, a, b in self.device:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps, last = [], self.start_us
        for a, b in merged([(a, b) for _, a, b in self.device]) + [[self.end_us, self.end_us]]:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_at(0.5 * (a + b)), (b - a) / 1e6] for a, b in gaps]}

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t`` (the shortest one
        that spans it), or ``host`` where none does."""
        best, width = "host", np.inf
        for n, a, b in self.host:
            if a <= t <= b and b - a < width and n != MARK and not n.startswith(PROFILER_OPS):
                best, width = n, b - a
        return best


class Slice:
    """Profile from ``start()`` to ``stop()``, which returns the slice."""

    def __init__(self, device: torch.device):
        self.device, self.prof = device, None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()
        self.t0 = perf_counter()

    def stop(self) -> TraceData:
        self._sync()
        wall = perf_counter() - self.t0
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        data = TraceData(window_us=wall * 1e6)
        for e in self.prof.events():
            rng = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # Kernels, copies and sets; not the user annotation that
                # the slice's mark projects onto the device's timeline.
                if not getattr(e, "is_user_annotation", False) and e.name != MARK:
                    data.device.append(rng)
            elif e.name == MARK:
                data.start_us, data.end_us = rng[1], rng[2]
            else:
                data.host.append(rng)
        if data.end_us <= data.start_us:
            data.start_us = min((a for _, a, _ in data.device + data.host), default=0.0)
            data.end_us = data.start_us + data.window_us
        self.prof = None
        return data
