"""Bike5D: state ``(p_x, p_y, v, psi, delta)``, controls ``(a, delta_dot)``,
one RK4 substep a control period (labicon/dp-ilqr ``dynamics.py:74``, the
sympy bicycle, integrated by one RK4 step of ``dt``)."""

import torch

NX, NU, SUBSTEPS = 5, 2, 1


def f(x, u):
    v, psi, delta = x[..., 2], x[..., 3], x[..., 4]
    return torch.stack([v * torch.cos(psi), v * torch.sin(psi), u[..., 0],
                        v * torch.tan(delta), u[..., 1]], -1)


def jac(x, u):
    """Continuous Jacobians ``A (..., NX, NX)``, ``B (..., NX, NU)``."""
    v, psi, delta = x[..., 2], x[..., 3], x[..., 4]
    tan = torch.tan(delta)
    A = x.new_zeros((*x.shape, 5))
    A[..., 0, 2] = torch.cos(psi)
    A[..., 0, 3] = -v * torch.sin(psi)
    A[..., 1, 2] = torch.sin(psi)
    A[..., 1, 3] = v * torch.cos(psi)
    A[..., 3, 2] = tan
    A[..., 3, 4] = v * (1.0 + tan * tan)
    B = x.new_zeros((*x.shape, 2))
    B[..., 2, 0] = 1.0
    B[..., 4, 1] = 1.0
    return A, B
