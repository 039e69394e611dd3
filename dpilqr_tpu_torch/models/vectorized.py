"""Layout-agnostic model right-hand sides, batched over any leading dims.

Counterpart of ``dpilqr_tpu/models/vectorized.py``.  Each model's
continuous-time RHS is declared once, as a function of component getters
``X(i), U(j)`` returning a ``{state component: dx/dt}`` map; components a
model does not list (padding, Human6D's height) have zero derivative.  The
CUDA forward kernel (``csrc/forward_batched.cu``) inlines the same formulas,
one ``__device__`` function per model.

Heterogeneous batches evaluate every unique model on the whole batch and
select per row by branch index (the counterpart of ``lax.switch`` under
``vmap``).  The functions take a ``ModelSpec`` or a built-in model's name;
a custom spec (one with its own ``f``) is evaluated through that ``f`` on
its native dims and zero-padded.
"""

from __future__ import annotations

import torch

from .specs import (
    _Q12_CX,
    _Q12_CY,
    _Q12_CZ,
    _Q12_KF,
    _Q12_KTX,
    _Q12_KTY,
    _Q12_KTZ,
    GRAVITY,
    ModelSpec,
    TableRHS,
)


def rhs_double_int_4d(X, U):
    return {0: X(2), 1: X(3), 2: U(0), 3: U(1)}


def rhs_double_int_6d(X, U):
    return {0: X(3), 1: X(4), 2: X(5), 3: U(0), 4: U(1), 5: U(2)}


def rhs_car_3d(X, U):
    return {0: U(0) * torch.cos(X(2)), 1: U(0) * torch.sin(X(2)), 2: U(1)}


def rhs_unicycle_4d(X, U):
    return {
        0: X(2) * torch.cos(X(3)),
        1: X(2) * torch.sin(X(3)),
        2: U(0),
        3: U(1),
    }


def rhs_human_6d(X, U):
    return {0: X(3) * torch.cos(U(0)), 1: X(3) * torch.sin(U(0)), 3: U(1)}


def rhs_human_lin_6d(X, U):
    return {0: X(3), 1: X(4), 3: U(0), 4: U(1)}


def rhs_quad_6d(X, U):
    g = GRAVITY
    return {
        0: X(3),
        1: X(4),
        2: X(5),
        3: g * torch.tan(U(2)),
        4: -g * torch.tan(U(1)),
        5: U(0) - g,
    }


def rhs_quad_12d(X, U):
    g = GRAVITY
    psi, th, ph = X(3), X(4), X(5)
    vx, vy, vz = X(6), X(7), X(8)
    wx, wy, wz = X(9), X(10), X(11)
    sps, cps = torch.sin(psi), torch.cos(psi)
    sth, cth = torch.sin(th), torch.cos(th)
    sph, cph = torch.sin(ph), torch.cos(ph)
    tth = torch.tan(th)
    return {
        0: vx * cps * cth + vy * (sph * sth * cps - sps * cph)
           + vz * (sph * sps + sth * cph * cps),
        1: vx * sps * cth + vy * (sph * sps * sth + cph * cps)
           + vz * (-sph * cps + sps * sth * cph),
        2: -vx * sth + vy * sph * cth + vz * cph * cth,
        3: wy * sph / cth + wz * cph / cth,
        4: wy * cph - wz * sph,
        5: wx + wy * sph * tth + wz * cph * tth,
        6: vy * wz - vz * wy + g * sth,
        7: -vx * wz + vz * wx - g * sph * cth,
        8: _Q12_KF * U(3) + vx * wy - vy * wx - g * cph * cth,
        9: _Q12_KTX * U(0) - _Q12_CX * wy * wz,
        10: _Q12_KTY * U(1) + _Q12_CY * wx * wz,
        11: _Q12_KTZ * U(2) - _Q12_CZ * wx * wy,
    }


def rhs_bike_5d(X, U):
    return {
        0: X(2) * torch.cos(X(3)),
        1: X(2) * torch.sin(X(3)),
        2: U(0),
        3: X(2) * torch.tan(X(4)),
        4: U(1),
    }


RHS = {
    "DoubleInt4D": rhs_double_int_4d,
    "DoubleInt6D": rhs_double_int_6d,
    "Car3D": rhs_car_3d,
    "Unicycle4D": rhs_unicycle_4d,
    "Human6D": rhs_human_6d,
    "HumanLin6D": rhs_human_lin_6d,
    "Quad6D": rhs_quad_6d,
    "Quad12D": rhs_quad_12d,
    "Bike5D": rhs_bike_5d,
}


def padded_f(model, x, u):
    """``x (..., nx_p)``, ``u (..., nu_p)`` -> ``xdot (..., nx_p)`` of
    ``model``, a ``ModelSpec`` or a built-in model's name."""
    if isinstance(model, ModelSpec) and not isinstance(model.f, TableRHS):
        xdot = model.f(x[..., : model.n_x], u[..., : model.n_u])
        return torch.nn.functional.pad(xdot, (0, x.shape[-1] - model.n_x))
    name = model.name if isinstance(model, ModelSpec) else model
    cols = RHS[name](lambda i: x[..., i], lambda j: u[..., j])
    zero = torch.zeros_like(x[..., 0])
    return torch.stack([cols.get(c, zero) for c in range(x.shape[-1])], -1)


def padded_jacobians(model, x, u):
    """Exact continuous Jacobians of ``padded_f``: ``A_c (..., nx_p, nx_p)``,
    ``B_c (..., nx_p, nu_p)`` (forward-mode AD, row-vectorized)."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    uf = u.reshape(-1, u.shape[-1])
    jac = torch.func.jacfwd(lambda a, b: padded_f(model, a, b), argnums=(0, 1))
    A, B = torch.func.vmap(jac)(xf, uf)
    # Forward mode promotes the tangents of terms with a Python-float
    # constant (the quadrotors' gravity) to float64: cast back.
    A, B = A.to(x.dtype), B.to(x.dtype)
    return A.reshape(*lead, *A.shape[-2:]), B.reshape(*lead, *B.shape[-2:])


def unique_branches(specs: tuple[ModelSpec, ...]) -> list[ModelSpec]:
    """Unique models in first-appearance order (the branch table)."""
    seen: dict[int, ModelSpec] = {}
    for s in specs:
        seen.setdefault(s.model_id, s)
    return list(seen.values())


def select_branches(outs, branch_idx, value_ndim: int = 1):
    """Per-row selection among per-branch results.

    ``outs`` is a list (one entry per branch) of tensors ``(*lead, *value)``
    with ``value_ndim`` trailing value dims; ``branch_idx`` (broadcasting
    against ``lead``) picks the entry for each row."""
    if len(outs) == 1:
        return outs[0]
    out = outs[0]
    for b in range(1, len(outs)):
        sel = branch_idx == b
        sel = sel.reshape(*sel.shape, *([1] * value_ndim))
        out = torch.where(sel, outs[b], out)
    return out


def blended_f(specs: tuple[ModelSpec, ...]):
    """Fleet RHS ``f(x, u, branch_idx) -> xdot`` over the unique models of
    ``specs``; ``branch_idx (*lead)`` indexes that table (ignored when the
    fleet has one model)."""
    branches = unique_branches(specs)

    def f(x, u, branch_idx=None):
        return select_branches([padded_f(s, x, u) for s in branches], branch_idx)

    return f
