"""``conv_frac``: the batched driver's useful outcomes over its attempts,
the share of the window's subproblem solves flagged converged."""

import numpy as np

NAME, UNIT, SOURCE = "conv_frac", "%", "program_counter"
LAYER, MOVES = "Batched driver (ops/batched.py)", "plan_cost"


def read(run):
    flags = [s.converged for s in run.steps] + [b.converged for b in run.batches]
    if not flags:
        return None
    return 100.0 * float(np.concatenate(flags).mean())
