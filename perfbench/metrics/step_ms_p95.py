"""``step_ms_p95``: the 95th percentile of every step of the window, a
step's time being the host clock from the previous step's commit (or its
episode's start) to its own, redone auto-K solves included."""

import numpy as np

NAME, UNIT, SOURCE, LAYER, MOVES = "step_ms_p95", "ms", "host_clock", None, None


def read(run):
    if run.kind != "closed_loop" or not run.steps:
        return None
    return float(np.percentile([s.ms for s in run.steps if not s.traced], 95))
