"""``idle_frac.mpc``: the device's idle share over the traced slice, 1
minus the union of its kernel and copy intervals over the slice's wall
time (``harness/trace.py`` ``union_length``, copied from
``bench_torch.py``)."""

NAME, UNIT, SOURCE = "idle_frac.mpc", "%", "device_trace"
LAYER, MOVES = "Device (H100)", "step_ms"


def read(run):
    if run.kind != "closed_loop" or run.trace is None or run.trace.window_us <= 0:
        return None
    if not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
