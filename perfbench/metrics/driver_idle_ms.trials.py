"""``driver_idle_ms.trials``: the device's idle milliseconds a traced
trial while the batched driver's host work held it: idle time of the
traced slice under the program's ``dpilqr.batched.*`` spans, over the
trials of the traced batches (``harness/spans.py``)."""

from perfbench.harness.spans import layer_idle_ms, traced_trials

NAME, UNIT, SOURCE = "driver_idle_ms.trials", "ms", "program_span"
LAYER, MOVES = "Batched driver (ops/batched.py)", "trial_ms"


def read(run):
    if run.kind != "trial_batch":
        return None
    return layer_idle_ms(run, "batched", traced_trials(run))
