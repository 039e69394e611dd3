"""What a window leaves for the metrics' readers and the check."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class WindowClosed(Exception):
    """Raised from the loop's step callback once the window's time is up."""


@dataclass
class Step:
    """One committed MPC step: host milliseconds since the previous commit
    (or the episode's start), the program's own solve time, the width it
    was solved at, each subproblem's iterations and converged flag, and in
    a traced step the interaction graph's rows, one a subproblem."""

    ms: float
    solve_s: float
    K: int
    iters: np.ndarray
    converged: np.ndarray
    traced: bool
    members: np.ndarray | None = None


@dataclass
class Batch:
    """One trial batch: host milliseconds, trials, every subproblem's
    iterations and converged flag, and in a traced batch every trial's
    interaction graph's rows, one a subproblem (trial by trial)."""

    ms: float
    trials: int
    K: int
    iters: np.ndarray
    converged: np.ndarray
    truncated: int
    traced: bool
    members: np.ndarray | None = None


@dataclass
class Run:
    """A run as the readers of ``metrics/`` see it."""

    kind: str
    problem: object
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    untraced_s: float = 0.0  # the window's time outside the traced slice
    steps: list = field(default_factory=list)  # Step
    batches: list = field(default_factory=list)  # Batch
    units: int = 0  # episodes or batches completed in the window
    plan_costs: list = field(default_factory=list)  # (scenario key, the reference's cost)
    trace: object = None  # trace.TraceData of the slice (--trace 1)
    attempted: int = 0
    failed: int = 0
