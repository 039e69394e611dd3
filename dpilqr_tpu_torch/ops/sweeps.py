"""The centralized solve's two sweep kernels.

Counterpart of ``dpilqr_tpu/ops/pallas_sweeps.py``: one iLQR problem over
the whole fleet (``X (N+1, n, nx_p)``, ``U (N, n, nu_p)``), flat gains
``K (N, nuf, nxf)``, ``d (N, nuf)`` with ``nxf = n nx_p``, ``nuf = n nu_p``.

- ``backward_pass_cuda``: the whole of ``backward_pass_pallas``, its
  quadraticization and linearization included, as ONE launch of kernel
  ``csrc/backward_sweep.cu``, which computes each step's Jacobians and cost
  derivatives itself (twin: ``ops.ilqr._backward_pass``);
- ``forward_pass_cuda``: the closed-loop line search over all alphas,
  kernel ``csrc/forward_sweep.cu`` (twin: ``ops.ilqr._forward_pass``), and
  ``rollout_cuda``, the same kernel with no gains: the plain rollout of a
  fleet of any size (twins: ``ops.ilqr._rollout_fn``,
  ``_rollout_batched_cost``), which ``ops.ilqr.rollout`` routes every CUDA
  rollout to (the stitched plan's joint cost, the executed trajectory's).

The wrappers take CUDA tensors only and raise otherwise; between the caller
and a kernel they only check arguments and allocate outputs.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..models.fleet import Fleet
from .batched import _dt_tensor, _slot_tables
from .costs import GameCost, cast_cost
from .cuda_build import (check_tensors, forward_plan, launch, require_cuda,
                         require_kernel_models, riccati_plan)


@lru_cache(maxsize=64)
def _branch_indices(fleet: Fleet, device):
    """``fleet.branch_index_array`` on ``device``, copied once: it is a host
    array, and a copy from pageable memory waits for the stream."""
    return torch.as_tensor(fleet.branch_index_array, device=device)


def backward_pass_cuda(fleet: Fleet, cost: GameCost, X, U, mu):
    """The centralized Riccati sweep about ``(X, U)`` with regularization
    ``mu ()``, its inputs (Euler-discretized Jacobians, the cost's gradient
    and Hessian blocks) computed inside the one launch of
    ``csrc/backward_sweep.cu``; returns ``K (N, nuf, nxf)``, ``d (N,
    nuf)``."""
    library = require_kernel_models(fleet)
    require_cuda("backward_sweep", X)
    N, n, nu_p = U.shape
    nx_p = X.shape[-1]
    if fleet.n_agents != n or fleet.nx_p != nx_p or fleet.nu_p != nu_p:
        raise ValueError("X/U shapes do not match the fleet")
    nxf, nuf = n * nx_p, n * nu_p
    dtype, dev = X.dtype, X.device
    cost = cast_cost(cost, dtype)
    model = _agent_tables(fleet, dtype, dev)[0]
    ins = dict(X=X, U=U, xf=cost.xf, Q=cost.Q, R=cost.R, Qf=cost.Qf,
               mask=cost.agent_mask, refw=cost.ref_weight.reshape(1),
               radius=cost.radius.reshape(1), proxw=cost.prox_weight.reshape(1),
               npos=cost.n_pos, model=model, dt=_dt_tensor(fleet.dt, dtype, dev),
               mu=torch.as_tensor(mu, dtype=dtype, device=dev).reshape(1))
    check_tensors("backward_sweep", ins, dict(
        X=(N + 1, n, nx_p), U=(N, n, nu_p), xf=(n, nx_p), Q=(n, nx_p, nx_p),
        R=(n, nu_p, nu_p), Qf=(n, nx_p, nx_p), mask=(n,), refw=(1,), radius=(1,),
        proxw=(1,), npos=(n,), model=(n,), dt=(1,), mu=(1,)),
        dtype, dev, ints=("npos", "model"))
    plan = riccati_plan(n, nx_p, nu_p, X.element_size())
    work = X.new_empty((plan.work,))
    K = X.new_empty((N, nuf, nxf))
    d = X.new_empty((N, nuf))
    launch("backward_sweep", dtype, dev, *ins.values(), K, d, work, plan.work,
           N, n, nx_p, nu_p, library=library, tier=plan.tier)
    return K, d


# Parts a step's cost may be split into by the plain rollout
# (COST_PARTS_MAX in csrc/forward_sweep.cu): its scratch is one value a part
# and step.
ROLLOUT_COST_PARTS = 32


def _agent_tables(fleet: Fleet, dtype, device):
    """Per-agent ``(model id, RK4 substeps, dh)`` of ``fleet`` on ``device``
    (the ids of the library that runs it), built once per fleet, its
    models' sympy forms, type and device."""
    forms = tuple(s.expr for s in fleet.unique_specs)
    return _agent_tables_cached(fleet, forms, dtype, device)


@lru_cache(maxsize=64)
def _agent_tables_cached(fleet: Fleet, _forms, dtype, device):
    tables = _slot_tables(fleet, _branch_indices(fleet, device), dtype)
    return tuple(t.contiguous() for t in tables)


def _launch_forward_sweep(fleet: Fleet, cost: GameCost, X, U, K, d, alphas,
                          max_rows: int = 0):
    """Check the inputs of ``csrc/forward_sweep.cu`` and launch it: with
    gains ``X (N+1, n, nx_p)`` is the nominal trajectory, without
    ``X (n, nx_p)`` the initial state and ``alphas`` is None (one column)."""
    library = require_kernel_models(fleet)
    require_cuda("forward_sweep", X)
    gains = K is not None
    N, n, nu_p = U.shape
    nx_p = X.shape[-1]
    nxf, nuf = n * nx_p, n * nu_p
    n_alpha = alphas.shape[0] if gains else 1
    if fleet.n_agents != n or fleet.nx_p != nx_p or fleet.nu_p != nu_p:
        raise ValueError("X/U shapes do not match the fleet")
    dtype, dev = X.dtype, X.device
    cost = cast_cost(cost, dtype)
    model, nsub, dh = _agent_tables(fleet, dtype, dev)
    ins = dict(X=X, U=U, K=K, d=d, alphas=alphas, model=model, nsub=nsub,
               dh=dh, xf=cost.xf, Q=cost.Q, R=cost.R, Qf=cost.Qf,
               mask=cost.agent_mask, refw=cost.ref_weight.reshape(1),
               radius=cost.radius.reshape(1),
               proxw=cost.prox_weight.reshape(1), npos_eval=cost.n_pos_eval)
    shapes = dict(X=(N + 1, n, nx_p) if gains else (n, nx_p), U=(N, n, nu_p),
                  K=(N, nuf, nxf), d=(N, nuf), alphas=(n_alpha,), model=(n,),
                  nsub=(n,), dh=(n,), xf=(n, nx_p), Q=(n, nx_p, nx_p),
                  R=(n, nu_p, nu_p), Qf=(n, nx_p, nx_p), mask=(n,), refw=(1,),
                  radius=(1,), proxw=(1,), npos_eval=(n,))
    check_tensors("forward_sweep",
                  {k: v for k, v in ins.items() if v is not None}, shapes,
                  dtype, dev, ints=("model", "nsub", "npos_eval"))
    X_c = X.new_empty((n_alpha, N + 1, n, nx_p))
    U_c = X.new_empty((n_alpha, N, n, nu_p)) if gains else None
    J_c = X.new_empty((n_alpha,))
    work = None if gains else X.new_empty(((N + 1) * ROLLOUT_COST_PARTS,))
    launch("forward_sweep", dtype, dev, *ins.values(), X_c, U_c, J_c, work,
           n, N, nx_p, nu_p, n_alpha, 0 if gains else work.numel(), max_rows,
           library=library)
    return X_c, U_c, J_c


def forward_pass_cuda(fleet: Fleet, cost: GameCost, X, U, K, d, alphas,
                      max_rows: int = 0):
    """Launch ``csrc/forward_sweep.cu`` with gains: the closed-loop rollouts
    ``u = U + K (x - X) + alpha d`` for all ``alphas (n_alpha,)`` in one
    launch, a warp per alpha.  Returns ``X_c (n_alpha, N+1, n, nx_p)``,
    ``U_c (n_alpha, N, n, nu_p)``, ``J_c (n_alpha,)``.  A step's gain block
    comes whole or in tiles of rows (``cuda_build.forward_plan`` with K =
    n, which raises past one warp's column beside a 4-row tile);
    ``max_rows`` > 0 forces tiles of at most that many rows, as in
    ``batched.forward_pass_batched_cuda``."""
    if K is None or d is None:
        raise ValueError("forward_pass_cuda takes gains K and d; the plain "
                         "rollout of U is rollout_cuda")
    N, n, nu_p = U.shape
    forward_plan(n, X.shape[-1], nu_p, alphas.shape[0], X.element_size())
    return _launch_forward_sweep(fleet, cost, X, U, K, d, alphas, max_rows)


def rollout_cuda(fleet: Fleet, cost: GameCost, x0, U):
    """The plain rollout of ``U (N, n, nu_p)`` from ``x0 (n, nx_p)`` on
    ``csrc/forward_sweep.cu`` without gains: a thread per agent integrates,
    a grid of (step, pair tile) blocks sums the cost in a fixed order (J has
    the same bits in every run), for fleets of any size.  Returns ``X (N+1,
    n, nx_p)``, ``J ()``."""
    X_c, _, J_c = _launch_forward_sweep(fleet, cost, x0, U, None, None, None)
    return X_c[0], J_c[0]
