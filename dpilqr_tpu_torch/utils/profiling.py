"""Profiling utilities.

Counterpart of ``dpilqr_tpu/utils/profiling.py``:

- ``trace(logdir)``: context manager around ``torch.profiler`` (CPU and CUDA
  activities) that writes a chrome trace of everything inside into
  ``logdir`` and yields the profiler (``key_averages()`` sums by kernel).
- ``hard_sync``: waits for the device (``torch.cuda.synchronize``); PyTorch
  returns from a launch before the device finishes, so a host clock is only
  meaningful after it.
- ``timed_solve``: steady-state wall seconds per call.
- ``cuda_min_ms``: a callable's time on the device from CUDA events, the
  minimum of k runs after a warm-up.
- ``span(name)``: a named host range of the program, recorded only while a
  ``torch.profiler`` session records (``trace`` among them).
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from time import perf_counter

import torch

# What ``span`` returns while no profiler records: one shared context that
# does nothing.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program's host work: inside a ``torch.profiler``
    session a ``record_function(name)`` range, on the profiler's clock (the
    one its CUDA kernels carry, so a range lies against the kernels as it
    is); outside one the shared no-op context, after one check.

    Names read ``dpilqr.<layer>.<section>``, ``<layer>`` one of ``rhc``,
    ``distributed``, ``mesh``, ``batched``; a range around a device-to-host
    read ends in ``.read``, and no other does."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and export a chrome trace
    (``logdir/trace.json``, loadable in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            hard_sync()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def hard_sync():
    """Wait until the device has finished all queued work (a no-op without
    CUDA, where every op is synchronous)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_solve(fn, *args, reps: int = 20) -> float:
    """Steady-state wall seconds per call: one warm-up call, then ``reps``
    calls between two device syncs."""
    fn(*args)
    hard_sync()
    t0 = perf_counter()
    for _ in range(reps):
        fn(*args)
    hard_sync()
    return (perf_counter() - t0) / reps


def cuda_min_ms(fn, reps: int = 1, k: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA device: after one
    warm-up call, ``k`` runs of ``reps`` calls each between two CUDA events;
    the minimum run over ``reps``."""
    if k < 1 or reps < 1:
        raise ValueError("k and reps must be positive")
    fn()
    best = float("inf")
    for _ in range(k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best

