"""Quad6D: state ``(p_x, p_y, p_z, v_x, v_y, v_z)``, controls: the vertical
acceleration (gravity subtracted) and two tilt angles, five RK4 substeps a
control period (labicon/dp-ilqr ``bbdynamics.cpp``)."""

import torch

NX, NU, SUBSTEPS = 6, 3, 5
GRAVITY = 9.80665


def f(x, u):
    g = GRAVITY
    return torch.stack([x[..., 3], x[..., 4], x[..., 5], g * torch.tan(u[..., 2]),
                        -g * torch.tan(u[..., 1]), u[..., 0] - g], -1)


def jac(x, u):
    """Continuous Jacobians ``A (..., NX, NX)``, ``B (..., NX, NU)``."""
    g = GRAVITY
    A = x.new_zeros((*x.shape, 6))
    A[..., 0, 3] = A[..., 1, 4] = A[..., 2, 5] = 1.0
    B = x.new_zeros((*x.shape, 3))
    B[..., 3, 2] = g * (1.0 + torch.tan(u[..., 2]) ** 2)
    B[..., 4, 1] = -g * (1.0 + torch.tan(u[..., 1]) ** 2)
    B[..., 5, 0] = 1.0
    return A, B
