"""Car3D: state ``(p_x, p_y, theta)``, controls ``(v, omega)``, five RK4
substeps a control period (labicon/dp-ilqr ``bbdynamics.cpp``).  The tests
load it beside the shipped models for a fleet of mixed state sizes."""

import torch

NX, NU, SUBSTEPS = 3, 2, 5


def f(x, u):
    th = x[..., 2]
    return torch.stack([u[..., 0] * torch.cos(th), u[..., 0] * torch.sin(th), u[..., 1]], -1)


def jac(x, u):
    """Continuous Jacobians ``A (..., NX, NX)``, ``B (..., NX, NU)``."""
    th = x[..., 2]
    A = x.new_zeros((*x.shape, 3))
    A[..., 0, 2] = -u[..., 0] * torch.sin(th)
    A[..., 1, 2] = u[..., 0] * torch.cos(th)
    B = x.new_zeros((*x.shape, 2))
    B[..., 0, 0] = torch.cos(th)
    B[..., 1, 0] = torch.sin(th)
    B[..., 2, 1] = 1.0
    return A, B
