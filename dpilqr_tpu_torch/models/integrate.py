"""Integrators and discretization.

Counterpart of ``dpilqr_tpu/models/integrate.py``: classic RK4 with
``substeps`` equal sub-intervals per control period
(dpilqr/bbdynamics.cpp:39-93) and forward-Euler discretization of the
continuous Jacobians (dpilqr/bbdynamics.cpp:95-106).
"""

from __future__ import annotations

import torch


def rk4_step(f, x, u, dh):
    """One classic Runge-Kutta-4 step of size ``dh`` under zero-order hold.

    ``dh`` may be a float or a tensor broadcasting against ``x``."""
    k0 = f(x, u)
    k1 = f(x + 0.5 * dh * k0, u)
    k2 = f(x + 0.5 * dh * k1, u)
    k3 = f(x + dh * k2, u)
    return x + dh * (k0 + 2.0 * k1 + 2.0 * k2 + k3) / 6.0


def rk4_integrate(f, x, u, dt, substeps: int):
    """Integrate ``x_dot = f(x, u)`` over ``dt`` with ``substeps`` RK4 steps."""
    dh = dt / substeps
    for _ in range(substeps):
        x = rk4_step(f, x, u, dh)
    return x


def euler_discretize(A_c, B_c, dt):
    """Discretize continuous Jacobians: ``A_d = I + dt A_c``, ``B_d = dt B_c``."""
    n_x = A_c.shape[-1]
    eye = torch.eye(n_x, dtype=A_c.dtype, device=A_c.device)
    return eye + dt * A_c, dt * B_c
