"""DoubleInt4D: state ``(p_x, p_y, v_x, v_y)``, controls ``(a_x, a_y)``, five
RK4 substeps a control period (labicon/dp-ilqr ``bbdynamics.cpp``).  The
tests write it into ``reference/models/`` as a model that a later
configuration brings in a file of its own."""

import torch

NX, NU, SUBSTEPS = 4, 2, 5


def f(x, u):
    return torch.stack([x[..., 2], x[..., 3], u[..., 0], u[..., 1]], -1)


def jac(x, u):
    """Continuous Jacobians ``A (..., NX, NX)``, ``B (..., NX, NU)``."""
    A = x.new_zeros((*x.shape, 4))
    A[..., 0, 2] = A[..., 1, 3] = 1.0
    B = x.new_zeros((*x.shape, 2))
    B[..., 2, 0] = B[..., 3, 1] = 1.0
    return A, B
