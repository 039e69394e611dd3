"""Checkpoint / resume for receding-horizon runs.

The port's own copy of ``dpilqr_tpu/utils/checkpoint.py`` (numpy only, the
same ``.npz`` layout, so a checkpoint written by either package loads in
the other).  The RHC loop state -- current state, warm-start trajectory and
controls, simulated time, executed history -- is a checkpoint, so a run can
be stopped and resumed (``solve_rhc(checkpoint_path=, resume_state=)``).
``StepDumper`` writes one ``.npz`` per MPC step for offline analysis, in the
JAX package's layout too.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class RhcState:
    """Resumable receding-horizon loop state."""

    xi: np.ndarray  # (n, nx_p) current state
    X_warm: np.ndarray  # (N+1, n, nx_p) or (1, n, nx_p) warm trajectory
    U_warm: np.ndarray  # (N, n, nu_p) warm controls
    t: float  # simulated time
    X_full: np.ndarray  # executed history
    U_full: np.ndarray
    step: int = 0


def save_rhc_state(path, state: RhcState, extra: dict | None = None):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        xi=state.xi,
        X_warm=state.X_warm,
        U_warm=state.U_warm,
        t=state.t,
        X_full=state.X_full,
        U_full=state.U_full,
        step=state.step,
        extra=json.dumps(extra or {}),
    )


def load_rhc_state(path) -> tuple[RhcState, dict]:
    z = np.load(path, allow_pickle=False)
    state = RhcState(
        xi=z["xi"],
        X_warm=z["X_warm"],
        U_warm=z["U_warm"],
        t=float(z["t"]),
        X_full=z["X_full"],
        U_full=z["U_full"],
        step=int(z["step"]),
    )
    return state, json.loads(str(z["extra"]))



def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class StepDumper:
    """Per-MPC-step (X, U, J, graph) dumps for offline analysis: the JAX
    package's ``StepDumper``, taking tensors or arrays.  Step i goes to
    ``step_{i:05d}.npz`` in ``directory`` with ``X``, ``U``, ``J`` and the
    graph as JSON."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.i = 0

    def dump(self, X, U, J, graph=None):
        np.savez(
            self.dir / f"step_{self.i:05d}.npz",
            X=_host(X),
            U=_host(U),
            J=float(J),
            graph=json.dumps(graph or {}),
        )
        self.i += 1
