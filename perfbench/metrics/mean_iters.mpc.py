"""``mean_iters.mpc``: iLQR iterations a subproblem solve, over every
subproblem of every step of the window (the results' ``iters``)."""

import numpy as np

NAME, UNIT, SOURCE = "mean_iters.mpc", "iters", "program_counter"
LAYER, MOVES = "Batched driver (ops/batched.py)", "step_ms"


def read(run):
    if run.kind != "closed_loop" or not run.steps:
        return None
    return float(np.concatenate([s.iters for s in run.steps]).mean())
