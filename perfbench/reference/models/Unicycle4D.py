"""Unicycle4D: state ``(p_x, p_y, v, theta)``, controls ``(a, omega)``, five
RK4 substeps a control period (labicon/dp-ilqr ``bbdynamics.cpp``)."""

import torch

NX, NU, SUBSTEPS = 4, 2, 5


def f(x, u):
    v, th = x[..., 2], x[..., 3]
    return torch.stack([v * torch.cos(th), v * torch.sin(th), u[..., 0], u[..., 1]], -1)


def jac(x, u):
    """Continuous Jacobians ``A (..., NX, NX)``, ``B (..., NX, NU)``."""
    v, th = x[..., 2], x[..., 3]
    A = x.new_zeros((*x.shape, 4))
    A[..., 0, 2] = torch.cos(th)
    A[..., 0, 3] = -v * torch.sin(th)
    A[..., 1, 2] = torch.sin(th)
    A[..., 1, 3] = v * torch.cos(th)
    B = x.new_zeros((*x.shape, 2))
    B[..., 2, 0] = 1.0
    B[..., 3, 1] = 1.0
    return A, B
