"""iLQR building blocks shared by the solvers.

Counterpart of part of ``dpilqr_tpu/ops/ilqr.py``: the result record, the
line-search alphas, the unpivoted Gauss-Jordan solve and the nonlinear
rollouts (reference dpilqr/control.py:80-93,162).  The centralized
``ilqr_solve`` is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .costs import GameCost, stage_cost, terminal_cost


class SolveResult(NamedTuple):
    X: torch.Tensor  # (..., N+1, n, nx_p) state trajectory
    U: torch.Tensor  # (..., N, n, nu_p) control trajectory
    J: torch.Tensor  # (...) cost of (X, U)
    iters: torch.Tensor  # (...) iLQR iterations executed
    converged: torch.Tensor  # (...) bool: relative decrease < tol
    failed_line_search: torch.Tensor  # (...) bool: bailed out


def line_search_alphas(n_ls_iter: int, dtype=torch.float64, device=None):
    """``1.1 ** (-i^2)`` computed in float32 like the reference
    (dpilqr/control.py:162), cast to the solve dtype."""
    i = np.arange(n_ls_iter, dtype=np.float32)
    a = np.float32(1.1) ** (-(i**2))
    return torch.as_tensor(a, device=device).to(dtype)


def gauss_jordan_solve(M, R):
    """Solve ``M X = R`` by Gauss-Jordan elimination without pivoting.

    ``M (..., m, m)`` is the (SPD, regularized) ``Q_uu``, for which
    elimination without pivoting is stable; ``R (..., m, q)``."""
    m = M.shape[-1]
    MR = torch.cat([M, R], dim=-1)
    for k in range(m):
        pivot_row = MR[..., k : k + 1, :] / MR[..., k : k + 1, k : k + 1]
        col = MR[..., :, k : k + 1].clone()
        col[..., k, :] = 0.0
        MR = MR - col * pivot_row
        MR[..., k : k + 1, :] = pivot_row
    return MR[..., m:]


def _rollout_fn(step_fn, cost: GameCost, x0, U):
    """Nonlinear rollout accumulating cost (reference control.py:80-93).

    ``x0 (n, nx_p)``, ``U (N, n, nu_p)`` -> ``X (N+1, n, nx_p)``, ``J ()``."""
    x = x0
    J = torch.zeros((), dtype=x0.dtype, device=x0.device)
    X = [x0]
    for u_t in U:
        J = J + stage_cost(cost, x, u_t)
        x = step_fn(x, u_t)
        X.append(x)
    J = J + terminal_cost(cost, x)
    return torch.stack(X), J


def rollout(fleet, cost: GameCost, x0, U):
    """Public rollout on a static fleet: ``(X, J)``."""
    return _rollout_fn(fleet.step, cost, x0, U)


def _rollout_batched_cost(step_fn, cost: GameCost, x0, U):
    """Rollout with the cost evaluated time-batched after the state loop.

    Same math as ``_rollout_fn``; only the summation order differs (by a
    float rounding), so it computes the stitched-plan joint cost (reference
    distributed.py:99-103) and stays away from per-iteration accept
    decisions."""
    x = x0
    X = [x0]
    for u_t in U:
        x = step_fn(x, u_t)
        X.append(x)
    X = torch.stack(X)
    J = torch.sum(stage_cost(cost, X[:-1], U)) + terminal_cost(cost, X[-1])
    return X, J
