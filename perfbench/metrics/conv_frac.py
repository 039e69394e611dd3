"""``conv_frac``: the batched driver's useful outcomes over its attempts,
the share of the window's subproblem solves flagged converged (an
uncontrolled agent's lanes, which are not solved, left out)."""

import numpy as np

NAME, UNIT, SOURCE = "conv_frac", "%", "program_counter"
LAYER, MOVES = "Batched driver (ops/batched.py)", "plan_cost"


def read(run):
    on = ~run.problem.ignore_mask
    flags = ([s.converged[on] for s in run.steps]
             + [b.converged.reshape(-1, on.size)[:, on].ravel() for b in run.batches])
    if not flags:
        return None
    return 100.0 * float(np.concatenate(flags).mean())
