"""``trials_idle_ms.trials``: the device's idle milliseconds a traced
trial while the trial layer's host work held it: idle time of the traced
slice under the program's ``dpilqr.mesh.*`` spans (the T graphs and
gathers, the flattening, the chunks' copies, the T stitches and
rollouts), over the trials of the traced batches (``harness/spans.py``)."""

from perfbench.harness.spans import layer_idle_ms, traced_trials

NAME, UNIT, SOURCE = "trials_idle_ms.trials", "ms", "program_span"
LAYER, MOVES = "Trials, sharded solve (parallel/mesh.py)", "trial_ms"


def read(run):
    if run.kind != "trial_batch":
        return None
    return layer_idle_ms(run, "mesh", traced_trials(run))
