"""``mean_iters.mpc``: iLQR iterations a subproblem solve, over every
subproblem of every step of the window (the results' ``iters``), an
uncontrolled agent's lane, which is not solved, left out."""

import numpy as np

NAME, UNIT, SOURCE = "mean_iters.mpc", "iters", "program_counter"
LAYER, MOVES = "Batched driver (ops/batched.py)", "step_ms"


def read(run):
    if run.kind != "closed_loop" or not run.steps:
        return None
    on = ~run.problem.ignore_mask
    return float(np.concatenate([s.iters[on] for s in run.steps]).mean())
