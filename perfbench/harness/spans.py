"""The device's idle time in a traced slice, put down to the program's
spans: the host ranges named ``dpilqr.<layer>.<section>`` that the program
opens while a profiler records (``dpilqr_tpu_torch.utils.profiling.span``),
on the profiler's clock, as its kernels are.

Idle time is the slice, ``[start_us, end_us]``, less the union of its
device intervals.  Each idle instant goes to the innermost program span
open at that instant (the shortest; the profiler's own operations, torch's
and the slice's mark are not program spans); an idle interval is split
wherever a span opens or closes.  Idle time under no span goes to ``None``:
between episodes or batches it is the harness's own time.  A program
without spans (an older checkout) reads as having none: the readers
return nothing for it."""

from __future__ import annotations

from perfbench.harness.trace import merged

PREFIX = "dpilqr."


def program_spans(trace) -> list:
    """The slice's program spans, ``(name, start_us, end_us)``."""
    return [s for s in trace.host if s[0].startswith(PREFIX)]


def layer(name: str) -> str:
    """A span's layer: ``dpilqr.<layer>.<section>`` -> ``<layer>``."""
    return name.split(".")[1]


def idle_intervals(trace) -> list:
    """The slice's idle intervals, disjoint and in order."""
    out, last = [], trace.start_us
    for a, b in merged([(a, b) for _, a, b in trace.device]):
        if a > last:
            out.append((last, min(a, trace.end_us)))
        last = max(last, b)
        if last >= trace.end_us:
            break
    if last < trace.end_us:
        out.append((last, trace.end_us))
    return [(a, b) for a, b in out if b > a]


def innermost_segments(spans, start: float, end: float) -> list:
    """``[start, end]`` cut at every span's ends into ``(a, b, name)``
    segments, ``name`` the innermost span open over the segment (None
    where none is)."""
    cuts = sorted({start, end} | {t for _, a, b in spans for t in (a, b) if start < t < end})
    by_start = sorted(spans, key=lambda s: s[1])
    out, active, i = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(by_start) and by_start[i][1] <= a:
            active.append(by_start[i])
            i += 1
        active = [s for s in active if s[2] > a]
        inner = min(active, key=lambda s: s[2] - s[1], default=None)
        out.append((a, b, None if inner is None else inner[0]))
    return out


def idle_by_span(trace) -> dict:
    """Idle microseconds of the slice by the innermost program span open
    over them (``None``: under no span)."""
    segments = innermost_segments(program_spans(trace), trace.start_us, trace.end_us)
    out, j = {}, 0
    for a, b in idle_intervals(trace):
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s0, s1, name = segments[k]
            overlap = min(b, s1) - max(a, s0)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap
            k += 1
    return out


def layer_idle_ms(run, name: str, units: int, exclude=()) -> float | None:
    """Idle milliseconds of the traced slice under spans of layer ``name``
    (less the spans named in ``exclude``), over ``units`` traced steps or
    trials; None without a slice, without a device interval in it (the CPU
    rehearsal), without a span of the layer in it, or without units."""
    trace = run.trace
    if trace is None or not trace.device or units <= 0:
        return None
    if not any(layer(s[0]) == name for s in program_spans(trace)):
        return None
    us = sum(v for k, v in idle_by_span(trace).items()
             if k is not None and layer(k) == name and k not in exclude)
    return us / 1e3 / units


def traced_steps(run) -> int:
    return sum(s.traced for s in run.steps)


def traced_trials(run) -> int:
    return sum(b.trials for b in run.batches if b.traced)
