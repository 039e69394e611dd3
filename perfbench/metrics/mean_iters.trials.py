"""``mean_iters.trials``: iLQR iterations a subproblem solve, over every
subproblem of every trial batch of the window (the results' ``iters``,
trial by trial), an uncontrolled agent's lanes, which are not solved,
left out."""

import numpy as np

NAME, UNIT, SOURCE = "mean_iters.trials", "iters", "program_counter"
LAYER, MOVES = "Batched driver (ops/batched.py)", "trial_ms"


def read(run):
    if run.kind != "trial_batch" or not run.batches:
        return None
    on = ~run.problem.ignore_mask
    return float(np.concatenate([b.iters.reshape(-1, on.size)[:, on].ravel()
                                 for b in run.batches]).mean())
