"""Wall-clock-deadline (``t_kill``) distributed solve.

Counterpart of ``dpilqr_tpu/parallel/deadline.py``.  The reference threads
``t_kill`` from ``solve_distributed`` into every subproblem's solver
(dpilqr/distributed.py:170-176 kwargs -> problem.py:97-105 ->
control.py:213-218), and its real-time analysis mode caps every solve at
``t_kill = dt`` (scripts/analysis.py:145-148).  Here the deadline caps the
combined wall clock of all subproblems, stricter than the reference, which
grants each sequential subproblem its own ``t_kill``.

The batched subproblem solve (``ops.batched.solve_subproblems_batched``)
already steps from the host: each iLQR iteration over the whole batch is a
few kernel launches, and between iterations the host fetches the active
count.  The deadline check sits right after that fetch.  Nothing compiles
during a solve, so every compaction width is available under a deadline and
the schedule is the one ``solve_distributed`` uses.
"""

from __future__ import annotations

from time import perf_counter

from ..config import DEFAULT_CONFIG, SolverConfig
from ..models.fleet import Fleet
from ..ops.costs import GameCost
from .distributed import DistributedResult, _solve_decomposed


def solve_distributed_steppable(
    fleet: Fleet,
    cost: GameCost,
    X,
    U,
    radius,
    ignore_mask=None,
    K: int | None = None,
    graph_n_d: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
    t_kill: float | None = None,
    verbose: bool = False,
    device=None,
) -> DistributedResult:
    """``solve_distributed`` with a wall-clock deadline.

    Same arguments and result as ``solve_distributed`` plus ``t_kill``
    (seconds; None = no deadline, the same solve).  The clock starts at
    entry, so the graph and the gather count against the deadline.  Matches
    the reference's real-time contract (scripts/analysis.py:145-148,
    control.py:213-218): once the deadline passes, no further iLQR iteration
    starts and the best plan so far is stitched and returned; with ``t_kill
    = 0`` that is the rollout of the warm start, zero iterations.
    """
    t0 = perf_counter()
    return _solve_decomposed(
        fleet, cost, X, U, radius, ignore_mask, K, graph_n_d, config, device,
        t_kill=t_kill, t0=t0, verbose=verbose,
    )
