"""iLQR solver core: the centralized solve and the pieces the solvers share.

Counterpart of ``dpilqr_tpu/ops/ilqr.py``, with the reference algorithm
(dpilqr/control.py:15-242):

- initial rollout of the warm-start controls (control.py:80-93),
- backward Riccati recursion with Tassa-style regularization
  ``B^T (P + mu I) B`` (control.py:116-148),
- line search over ``alpha = 1.1 ** (-i^2)`` accepting the first cost
  decrease, all alphas evaluated in one batched forward pass
  (control.py:162,179-193),
- convergence on a relative decrease below ``tol``; bail-out when the line
  search fails (control.py:184,195-198); the regularization schedule
  (control.py:227-237).

The sweeps run as the hand-written kernels of ``ops/sweeps.py`` on CUDA
tensors ("cuda") or as the plain PyTorch versions here ("torch":
``_backward_pass``, ``_forward_pass``, ``_rollout_fn``); "auto" picks by the
device of ``x0``, and "pscan" swaps the backward sweep for the associative
scan of ``ops/pscan.py``.  The iteration loop runs on the host with one sync
per iteration (the loop condition), so the deadline solve
(``ilqr_solve_steppable``, ``t_kill``) is the same loop with a clock.

Entry points given numpy input and no ``device`` run on the card
(``config.default_device``); a tensor argument keeps its device.
"""

from __future__ import annotations

import os
from time import perf_counter
from typing import NamedTuple

import numpy as np
import torch

from ..config import (DEFAULT_CONFIG, SWEEP_BACKENDS, SolverConfig, resolve_backend,
                      resolve_device)
from ..models.fleet import Fleet
from .costs import (
    GameCost,
    assemble_pair_hessian,
    cast_cost,
    diag_embed,
    quadraticize_stage_compact,
    quadraticize_terminal,
    stage_cost,
    terminal_cost,
)


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


def rollout_backend(device) -> str:
    """Which rollout serves tensors on ``device``: "cuda", the kernel
    ``csrc/forward_sweep.cu`` without gains, for a CUDA device; "torch", the
    plain versions ``_rollout_fn`` / ``_rollout_batched_cost``, for the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def rollout(fleet, cost: GameCost, x0, U, time_batched_cost: bool = False):
    """Public rollout on a static fleet: ``x0 (n, nx_p)``, ``U (N, n, nu_p)``
    -> ``X (N+1, n, nx_p)``, ``J ()``.

    Picks by the device of ``x0`` (``rollout_backend``): CUDA tensors take
    the kernel (``sweeps.rollout_cuda``; a failed launch raises), CPU tensors
    the plain versions: ``_rollout_fn``, or with ``time_batched_cost`` (the
    stitched plan's joint cost) ``_rollout_batched_cost``.  The kernel sums
    each step's cost and then the steps in order, so its J differs from
    either plain version by a float rounding."""
    if rollout_backend(x0.device) == "cuda":
        from . import sweeps

        return sweeps.rollout_cuda(fleet, cast_cost(cost, x0.dtype),
                                   x0.contiguous(), U.contiguous())
    plain = _rollout_batched_cost if time_batched_cost else _rollout_fn
    return plain(fleet.step, cost, x0, U)


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


def _forward_pass(step_fn, cost: GameCost, X, U, K, d, alphas):
    """Closed-loop rollouts ``du = K dx + alpha d`` for all ``alphas
    (n_alpha,)`` at once (reference control.py:95-114; the JAX package vmaps
    its ``_forward_pass`` over the alphas).  Returns ``X_c (n_alpha, N+1, n,
    nx_p)``, ``U_c (n_alpha, N, n, nu_p)``, ``J_c (n_alpha,)``."""
    N, n, nu_p = U.shape
    n_alpha = alphas.shape[0]
    x = X[0].expand(n_alpha, *X.shape[1:])
    J = X.new_zeros((n_alpha,))
    a = alphas[:, None]
    Xs, Us = [x], []
    for t in range(N):
        dx = (x - X[t]).reshape(n_alpha, -1)
        du = dx @ K[t].T + a * d[t]
        u = U[t] + du.reshape(n_alpha, n, nu_p)
        J = J + stage_cost(cost, x, u)
        x = step_fn(x, u)
        Xs.append(x)
        Us.append(u)
    J = J + terminal_cost(cost, x)
    return torch.stack(Xs, 1), torch.stack(Us, 1), J


def _backward_pass(lin_fn, cost: GameCost, X, U, mu):
    """Block Riccati recursion (reference control.py:116-148).

    Returns flat gains ``K (N, n nu_p, n nx_p)`` and ``d (N, n nu_p)``.  The
    quadraticization and linearization depend only on (X, U), so they run
    time-batched before the sequential sweep; the block sandwiches use the
    per-agent A and B, the gain solve and value update the flat space."""
    n, nx_p = X.shape[1], X.shape[2]
    N, _, nu_p = U.shape
    nxf, nuf = n * nx_p, n * nu_p
    L_xT, L_xxT = quadraticize_terminal(cost, X[-1])
    p = L_xT.reshape(nxf)
    P = L_xxT.reshape(nxf, nxf)
    eye_f = torch.eye(nxf, dtype=X.dtype, device=X.device)

    L_x, L_u, L_xx_diag, L_uu, H = quadraticize_stage_compact(cost, X[:-1], U)
    # The Hessian blocks do not depend on (X, U): give them the time axis.
    L_xx_diag = L_xx_diag.expand(N, n, nx_p, nx_p)
    L_uu = L_uu.expand(N, n, nu_p, nu_p)
    A, B = lin_fn(X[:-1], U)  # (N, n, nx, nx), (N, n, nx, nu)
    # Padded agents' input maps are zero: the recursion stays exactly
    # decoupled from them (ops/costs.py docstring).
    B = B * cost.agent_mask[None, :, None, None]
    L_uu_f = diag_embed(L_uu).reshape(N, nuf, nuf)

    K = X.new_empty((N, nuf, nxf))
    d = X.new_empty((N, nuf))
    for t in range(N - 1, -1, -1):
        A_t, B_t = A[t], B[t]
        L_xx = diag_embed(L_xx_diag[t])
        if n > 1:
            L_xx = L_xx + assemble_pair_hessian(H[t], n, nx_p)
        P4 = P.reshape(n, nx_p, n, nx_p)
        Preg4 = (P + mu * eye_f).reshape(n, nx_p, n, nx_p)
        p2 = p.reshape(n, nx_p)

        Q_x = L_x[t] + torch.einsum("iba,ib->ia", A_t, p2)
        Q_u = L_u[t] + torch.einsum("iba,ib->ia", B_t, p2)
        # Block sandwiches: only the (i, j) block pairs couple, through P.
        Q_xx = L_xx + torch.einsum("iba,ibjc,jcd->iajd", A_t, P4, A_t)
        Q_uu4 = torch.einsum("iba,ibjc,jcd->iajd", B_t, Preg4, B_t)
        Q_ux4 = torch.einsum("iba,ibjc,jcd->iajd", B_t, Preg4, A_t)

        Quu = Q_uu4.reshape(nuf, nuf) + L_uu_f[t]
        Qux = Q_ux4.reshape(nuf, nxf)
        Qu = Q_u.reshape(nuf)
        Qx = Q_x.reshape(nxf)
        Qxx = Q_xx.reshape(nxf, nxf)

        sol = gauss_jordan_solve(Quu, torch.cat([Qux, Qu[:, None]], dim=1))
        K_t = -sol[:, :nxf]
        d_t = -sol[:, nxf]
        K[t], d[t] = K_t, d_t

        KtQuu = K_t.T @ Quu
        p = Qx + KtQuu @ d_t + K_t.T @ Qu + Qux.T @ d_t
        P_new = Qxx + KtQuu @ K_t + K_t.T @ Qux + Qux.T @ K_t
        P = 0.5 * (P_new + P_new.T)
    return K, d


class IlqrCarry(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    J_star: torch.Tensor
    mu: torch.Tensor
    delta: torch.Tensor
    i: torch.Tensor
    converged: torch.Tensor
    failed: torch.Tensor


def env_sweep_backend() -> str | None:
    """The validated ``DPILQR_SWEEP_BACKEND`` override of every sweep
    backend (None if unset or "auto"), read first by both resolvers
    (``resolve_sweep_backend``, ``config.resolve_backend``): an operator's
    switch, as in the JAX package (dpilqr_tpu/ops/ilqr.py:281), with the
    port's names.  A typo raises here instead of surfacing as an unrelated
    dispatch error downstream."""
    env = os.environ.get("DPILQR_SWEEP_BACKEND")
    if env and env not in SWEEP_BACKENDS:
        raise ValueError(
            f"DPILQR_SWEEP_BACKEND={env!r} is not one of {SWEEP_BACKENDS}")
    return env if env and env != "auto" else None


def resolve_sweep_backend(cfg: SolverConfig, x, fleet: Fleet) -> str:
    """The sweep backend of a centralized solve of ``fleet`` on ``x``'s
    device and dtype: ``DPILQR_SWEEP_BACKEND`` if set, else
    ``cfg.sweep_backend``.  "auto" is the plain PyTorch sweeps for CPU
    tensors and the kernels for CUDA tensors -- unless K5 finds no tier for
    the problem (``cuda_build.riccati_plan``: its vectors alone exceed a
    block's shared memory), and then "pscan": the JAX package's rule (the
    fused kernel where it fits, the scan where it does not) without its TPU
    crossover at N >= 100, since on the card K5 beats the scan at every
    horizon.  An explicit "cuda" raises there; "pscan" stays "pscan".
    Wherever the forward sweep is to run on K4, K4's plan must place the
    problem too (``cuda_build.forward_plan``: one warp's column beside a
    4-row tile of gains), or this raises its ``ValueError`` before any
    launch: no backend solves such a fleet on the card."""
    from .cuda_build import forward_plan, riccati_plan

    requested = env_sweep_backend() or cfg.sweep_backend
    item = x.element_size()
    if requested == "pscan":
        backend = "pscan"
    else:
        backend = resolve_backend(requested, x)
        if backend == "cuda":
            try:
                riccati_plan(fleet.n_agents, fleet.nx_p, fleet.nu_p, item)
            except ValueError:
                if requested != "auto":
                    raise
                backend = "pscan"
    if backend == "cuda" or (backend == "pscan" and x.is_cuda):
        forward_plan(fleet.n_agents, fleet.nx_p, fleet.nu_p, cfg.n_ls_iter, item)
    return backend


def _sweeps(fleet: Fleet, backend: str):
    """``(rollout, backward, forward)`` sweep functions of ``backend``.
    Under "pscan" the backward sweep is the associative scan, and the
    rollouts are the card's kernel for CUDA tensors and the plain PyTorch
    versions for CPU tensors."""
    from . import sweeps

    torch_sweeps = (
        lambda cost, x0, U: _rollout_fn(fleet.step, cost, x0, U),
        lambda cost, X, U, mu: _backward_pass(fleet.linearize, cost, X, U, mu),
        lambda cost, X, U, K, d, a: _forward_pass(fleet.step, cost, X, U, K, d, a),
    )
    cuda_sweeps = (
        lambda cost, x0, U: sweeps.rollout_cuda(fleet, cost, x0, U),
        lambda cost, X, U, mu: sweeps.backward_pass_cuda(fleet, cost, X, U, mu),
        lambda cost, X, U, K, d, a: sweeps.forward_pass_cuda(
            fleet, cost, X, U, K, d, a),
    )
    if backend == "cuda":
        return cuda_sweeps
    if backend == "pscan":
        from .pscan import backward_pass_pscan

        def by_device(i):
            return lambda cost, x, *rest: (
                cuda_sweeps if x.is_cuda else torch_sweeps)[i](cost, x, *rest)

        return (
            by_device(0),
            lambda cost, X, U, mu: backward_pass_pscan(fleet.linearize, cost, X, U, mu),
            by_device(2),
        )
    return torch_sweeps


def make_iteration_fn(fleet: Fleet, cfg: SolverConfig, backend: str):
    """One iLQR iteration ``iterate(cost, carry) -> carry``: backward pass,
    line search over all alphas in one forward pass, accept, regularization
    and convergence, all on the device (no host sync)."""
    _, backward, forward = _sweeps(fleet, backend)
    alphas_on = {}  # (dtype, device) -> alphas, made once (a host copy)

    def iterate(cost: GameCost, c: IlqrCarry) -> IlqrCarry:
        dtype = c.X.dtype
        key = (dtype, c.X.device)
        if key not in alphas_on:
            alphas_on[key] = line_search_alphas(cfg.n_ls_iter, dtype, c.X.device)
        alphas = alphas_on[key]
        K, d = backward(cost, c.X, c.U, c.mu)
        X_c, U_c, J_c = forward(cost, c.X, c.U, K, d, alphas)

        improved = J_c < c.J_star  # (n_ls,)
        accept = torch.any(improved)
        a_idx = torch.argmax(improved.to(torch.int32)).reshape(1)  # first improving
        X_new = torch.where(accept, X_c.index_select(0, a_idx)[0], c.X)
        U_new = torch.where(accept, U_c.index_select(0, a_idx)[0], c.U)
        J_new = torch.where(accept, J_c.index_select(0, a_idx)[0], c.J_star)

        tiny = torch.finfo(dtype).tiny
        rel = torch.abs((c.J_star - J_new) / torch.clamp(torch.abs(c.J_star), min=tiny))
        converged = accept & (rel < cfg.tol)

        # Decrease regularization on acceptance (reference control.py:232-237);
        # with cfg.mu_floor mu bottoms out at mu_min instead of snapping to 0.
        delta_dec = torch.clamp(c.delta, max=1.0) / cfg.delta_0
        mu_dec = c.mu * delta_dec
        mu_lo = cfg.mu_min if cfg.mu_floor else 0.0
        mu_dec = torch.where(mu_dec <= cfg.mu_min, torch.full_like(mu_dec, mu_lo), mu_dec)
        if cfg.on_failed_ls == "increase":
            # The reference's (dead) regularization-increase path
            # (control.py:198-208): raise mu, keep iterating, abort at mu_max.
            delta_inc = torch.clamp(c.delta, min=1.0) * cfg.delta_0
            mu_inc = torch.clamp(c.mu * delta_inc, min=cfg.mu_min)
            mu_new = torch.where(accept, mu_dec, mu_inc)
            delta_new = torch.where(accept, delta_dec, delta_inc)
            failed = ~accept & (mu_inc >= cfg.mu_max)
        else:
            mu_new = torch.where(accept, mu_dec, c.mu)
            delta_new = torch.where(accept, delta_dec, c.delta)
            failed = ~accept

        return IlqrCarry(X_new, U_new, J_new, mu_new, delta_new, c.i + 1,
                         converged, failed)

    return iterate


def init_carry(fleet: Fleet, cfg: SolverConfig, cost: GameCost, x0, U0,
               backend: str) -> IlqrCarry:
    """Rollout of the warm start (control.py:80-93) and the initial carry."""
    rollout_fn, _, _ = _sweeps(fleet, backend)
    X0, J0 = rollout_fn(cost, x0, U0)
    dev = x0.device
    no = torch.zeros((), dtype=torch.bool, device=dev)
    return IlqrCarry(
        X=X0, U=U0, J_star=J0,
        mu=torch.tensor(cfg.mu_init, dtype=x0.dtype, device=dev),
        delta=torch.tensor(cfg.delta_0, dtype=x0.dtype, device=dev),
        i=torch.zeros((), dtype=torch.int32, device=dev),
        converged=no, failed=no.clone(),
    )


def solve_core(fleet: Fleet, cfg: SolverConfig, cost: GameCost, x0, U0,
               backend: str, t_kill: float | None = None,
               verbose: bool = False) -> SolveResult:
    """Full iLQR solve: iterate until convergence, a failed line search or
    ``cfg.n_lqr_iter`` iterations (the JAX package's while_loop), with one
    host sync per iteration for the loop condition.  With ``t_kill``
    (seconds) no iteration starts once that much wall time has passed since
    the loop began; the check follows each iteration's sync (reference
    control.py:213-218), so at least one iteration runs."""
    iterate = make_iteration_fn(fleet, cfg, backend)
    c = init_carry(fleet, cfg, cost, x0, U0, backend)
    t0 = perf_counter()
    for i in range(cfg.n_lqr_iter):
        c = iterate(cost, c)
        done = bool(c.converged | c.failed)  # the iteration's host sync
        if verbose:
            print(f"{i + 1}/{cfg.n_lqr_iter}\tJ: {float(c.J_star):g}")
        if done:
            break
        if t_kill is not None and perf_counter() - t0 > t_kill:
            break
    return SolveResult(X=c.X, U=c.U, J=c.J_star, iters=c.i,
                       converged=c.converged, failed_line_search=c.failed)


def _solve(fleet: Fleet, cfg: SolverConfig, cost: GameCost, x0, U0,
           **deadline) -> SolveResult:
    """The solve in ``x0``'s dtype and on its device (the cost follows)."""
    cost = cast_cost(GameCost(*(a.to(x0.device) for a in cost)), x0.dtype)
    U0 = U0.to(dtype=x0.dtype, device=x0.device).contiguous()
    return solve_core(fleet, cfg, cost, x0.contiguous(), U0,
                      resolve_sweep_backend(cfg, x0, fleet), **deadline)


def make_solver(fleet: Fleet, N: int, config: SolverConfig = DEFAULT_CONFIG):
    """The solve function for a fleet and horizon: ``solve(cost, x0 (n,
    nx_p), U0 (N, n, nu_p), device=None) -> SolveResult``, on ``x0``'s
    device when it is a tensor, else on ``device`` (default: the card)."""

    def solve(cost: GameCost, x0, U0, device=None):
        x0 = torch.as_tensor(x0, device=resolve_device(device, x0))
        U0 = torch.as_tensor(U0, dtype=x0.dtype, device=x0.device)
        if U0.shape[0] != N:
            raise ValueError(f"U0 has horizon {U0.shape[0]}, the solver {N}")
        return _solve(fleet, config, cost, x0, U0)

    return solve


def ilqr_solve(
    fleet: Fleet,
    cost: GameCost,
    x0,
    U0=None,
    N: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
    device=None,
) -> SolveResult:
    """Convenience single-problem entry point (reference ilqrSolver.solve).

    ``x0 (n, nx_p)``; ``U0 (N, n, nu_p)`` or None (zero controls over ``N``
    steps, like the reference control.py:152-153).  Runs in ``x0``'s dtype;
    a tensor ``x0`` keeps its device, numpy input goes to ``device``
    (default: the card, ``config.default_device``).
    """
    x0, U0 = _check_problem(fleet, cost, x0, U0, N, device)
    return _solve(fleet, config, cost, x0, U0)


def ilqr_solve_steppable(
    fleet: Fleet,
    cost: GameCost,
    x0,
    U0=None,
    N: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
    t_kill: float | None = None,
    verbose: bool = False,
    device=None,
) -> SolveResult:
    """``ilqr_solve`` honoring a wall-clock deadline (reference control.py:
    213-218): between iterations the host checks the clock and, once
    ``t_kill`` seconds have passed since the first iteration began, starts
    no further one and returns the best plan so far.  ``ilqr_solve`` already
    steps from the host with one sync per iteration, so with ``t_kill=None``
    this is the same solve."""
    x0, U0 = _check_problem(fleet, cost, x0, U0, N, device)
    return _solve(fleet, config, cost, x0, U0, t_kill=t_kill, verbose=verbose)


def _check_problem(fleet: Fleet, cost: GameCost, x0, U0, N, device):
    """``x0`` and ``U0`` as tensors on the solve's device, shapes checked."""
    x0 = torch.as_tensor(x0, device=resolve_device(device, x0))
    n = fleet.n_agents
    if tuple(x0.shape) != (n, fleet.nx_p):
        raise ValueError(
            f"x0 must have shape (n_agents, nx_p) = ({n}, {fleet.nx_p}), "
            f"got {tuple(x0.shape)}"
        )
    if U0 is None:
        if N is None:
            raise ValueError("Provide U0 or N")
        U0 = x0.new_zeros((N, n, fleet.nu_p))
    U0 = torch.as_tensor(U0, dtype=x0.dtype, device=x0.device)
    if U0.ndim != 3 or tuple(U0.shape[1:]) != (n, fleet.nu_p):
        raise ValueError(
            f"U0 must have shape (N, n_agents, nu_p) = (N, {n}, {fleet.nu_p}), "
            f"got {tuple(U0.shape)}"
        )
    if cost.xf.shape[0] != n:
        raise ValueError(f"cost has {cost.xf.shape[0]} agents but fleet has {n}")
    return x0, U0
