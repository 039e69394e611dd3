"""``driver_idle_ms.mpc``: the device's idle milliseconds a traced step
while the batched driver's host work held it: idle time of the traced
slice under the program's ``dpilqr.batched.*`` spans (the initial carry,
the graphs' lookup and loads, captures, replays, the active count's read
an iteration, compaction and scatter; ``harness/spans.py``)."""

from perfbench.harness.spans import layer_idle_ms, traced_steps

NAME, UNIT, SOURCE = "driver_idle_ms.mpc", "ms", "program_span"
LAYER, MOVES = "Batched driver (ops/batched.py)", "step_ms"


def read(run):
    if run.kind != "closed_loop":
        return None
    return layer_idle_ms(run, "batched", traced_steps(run))
