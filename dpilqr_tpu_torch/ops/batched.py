"""Batched iLQR over all subproblems: the two sweep kernels and their driver.

Counterpart of ``dpilqr_tpu/ops/pallas_batched.py``.  The decomposed solve
turns the n per-agent subproblems (reference dpilqr/distributed.py:25-103)
into one batch of S subproblems with K slots each, and every iteration runs
two batched sweeps over all of them:

- ``backward_pass_batched``: the Riccati recursion (reference
  control.py:116-148) with its inputs, as ONE launch of kernel
  ``csrc/backward_batched.cu`` for flat states up to 32 wide or
  ``csrc/backward_batched_wide.cu`` for every wider one whose working set
  the card can place (``cuda_build.riccati_plan``, the kernels' own plan of
  ``csrc/plan.h``); each kernel computes a step's
  Jacobians and cost derivatives itself (``csrc/computed_inputs.cuh``);
- ``forward_pass_batched``: the closed-loop line-search rollout over all
  alphas (control.py:95-114,162), kernel ``csrc/forward_batched.cu``.

The public shapes are the JAX package's: gains ``Kg (N, nuf, nxf, S)``,
``d (N, nuf, S)``, candidates ``X5 (N, nx_p, K, n_alpha, S)``.  In memory
the kernels and their twins keep a subproblem's step contiguous, gains as
``(S, N, nuf, nxf)`` and candidates column-major as ``(n_alpha, S, N, K,
nx_p)``, and hand the tensors out as permuted views (``GAIN_ORDER``,
``D_ORDER``, ``COLUMN_ORDER``): values and shapes are unchanged, the
forward kernel stages a step's gain block with one contiguous copy and
``select_alpha`` gathers whole rows.

Each kernel has a plain PyTorch version beside it: for the backward kernels
the time-batched quadraticization and linearization (``_quadraticize_batch``,
``_linearize_batch``, the JAX package's XLA phase) and the twin of the
recursion (``backward_pass_batched_torch``), for the forward kernel
``forward_pass_batched_torch``; the twins are Python loops over time with
the same block algebra as batched einsums.  ``backend`` "auto" takes the
kernel for CUDA tensors and the plain version for CPU tensors; "cuda" and
"torch" force one.  The kernels raise rather than fall back.

An iteration's line search runs its first alphas (the probe) and then the
rest (the tail) under a predicate the tail's kernel evaluates itself, and
its accept step is one more kernel, ``csrc/accept_batched.cu`` (plain
version ``accept_batched_torch``), which updates the carry in place and
writes the active count.  The batch loop (``solve_subproblems_batched``)
retires finished subproblems by halving compaction; on the card each
width's iteration is a CUDA graph of those four launches
(``IterationGraph``, the counterpart of the JAX package's
``lax.while_loop``), cached across calls, and the host reads one value an
iteration.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import lru_cache
from time import perf_counter
from typing import NamedTuple

import torch

from ..config import SolverConfig, resolve_backend
from ..models.fleet import Fleet
from ..models.vectorized import blended_f
from ..utils.profiling import span
from .costs import (
    GameCost,
    assemble_pair_hessian,
    cast_cost,
    diag_embed,
    quadraticize_stage_compact,
    quadraticize_terminal_compact,
    stage_cost,
    terminal_cost,
)
from .codegen import library_ids
from .cuda_build import (RiccatiPlan, bind, call, check_tensors, cluster_max, count,
                         forward_plan, require_cuda, require_kernel_models, riccati_plan,
                         run, timing)
from .ilqr import SolveResult, line_search_alphas

# Widest flat state (K * nx_p, and K * nu_p) of the narrow backward kernel,
# whose elimination keeps the tableau in one warp's registers; wider
# subproblems take the wide one.  Past that routing the only width limit is
# the card's: what the kernels' plans (``cuda_build.riccati_plan`` and
# ``forward_plan``) can place in the shared memory of a block (the rest lies
# in a device-memory workspace), e.g. Quad6D at K = 32 (nxf 192, nuf 96) in
# either type.
MAX_NXF = 32

# Compaction granularity of the retirement schedule (widths halve, rounded
# up to a multiple of this).
COMPACTION_UNIT = 16

# Memory orders behind the public shapes: ``t.permute(ORDER)`` is contiguous.
GAIN_ORDER = (3, 0, 1, 2)  # Kg (N, nuf, nxf, S) lies as (S, N, nuf, nxf)
D_ORDER = (2, 0, 1)  # d (N, nuf, S) lies as (S, N, nuf)
COLUMN_ORDER = (3, 4, 0, 2, 1)  # X5 (N, nx_p, K, n_alpha, S): (n_alpha, S, N, K, nx_p)


def _inverse(order):
    return tuple(order.index(i) for i in range(len(order)))


def as_layout(t, order):
    """``t`` with unchanged shape and values whose memory is contiguous in
    ``order`` (``t.permute(order).is_contiguous()``); a copy only where it
    is not already."""
    return t.permute(order).contiguous().permute(_inverse(order))


# ---------------------------------------------------------------------------
# Batched prep: the backward kernels' inputs in torch, for their plain
# version (the kernels compute them themselves).
# ---------------------------------------------------------------------------


def _time_cost(cost_b: GameCost) -> GameCost:
    """Per-subproblem cost ``(S, ...)`` -> broadcastable over time ``(S, 1, ...)``."""
    return GameCost(*(a.unsqueeze(1) for a in cost_b))


def _quadraticize_batch(cost_b: GameCost, X, U):
    """Time-batched quadraticization of a batch of subproblems.

    ``X (S, N+1, K, nx_p)``, ``U (S, N, K, nu_p)``; ``cost_b`` has a leading
    S axis on every field.  Returns subproblem-major contiguous tensors
    ``L_x (S, N, nxf)``, ``L_u (S, N, nuf)``, ``L_uu (S, N, nuf, nuf)``
    (block-diagonal), ``L_xx (S, N, nxf, nxf)`` (with proximity coupling),
    ``p0 (S, nxf)``, ``P0 (S, nxf, nxf)``.
    """
    S, Np1, K, nx_p = X.shape
    N = Np1 - 1
    nu_p = U.shape[-1]
    nxf, nuf = K * nx_p, K * nu_p

    L_x, L_u, L_xx_diag, L_uu, H = quadraticize_stage_compact(
        _time_cost(cost_b), X[:, :-1], U
    )
    L_xx = diag_embed(L_xx_diag)
    if K > 1:
        L_xx = L_xx + assemble_pair_hessian(H, K, nx_p)
    L_xT, L_xxT_diag, HT = quadraticize_terminal_compact(cost_b, X[:, -1])
    L_xxT = diag_embed(L_xxT_diag)
    if K > 1:
        L_xxT = L_xxT + assemble_pair_hessian(HT, K, nx_p)
    L_uu_bd = diag_embed(L_uu)
    return dict(
        L_x=L_x.reshape(S, N, nxf).contiguous(),
        L_u=L_u.reshape(S, N, nuf).contiguous(),
        L_uu=L_uu_bd.expand(S, N, K, nu_p, K, nu_p).reshape(S, N, nuf, nuf).contiguous(),
        L_xx=L_xx.expand(S, N, K, nx_p, K, nx_p).reshape(S, N, nxf, nxf).contiguous(),
        p0=L_xT.reshape(S, nxf).contiguous(),
        P0=L_xxT.reshape(S, nxf, nxf).contiguous(),
    )


def _linearize_batch(fleet: Fleet, cost_b: GameCost, mids_s, X, U):
    """Discretized Jacobians ``A (S, N, K, nx_p, nx_p)``,
    ``B (S, N, K, nx_p, nu_p)``; padded slots get ``B = 0`` so the
    recursion stays exactly decoupled from them."""
    A, B = fleet.linearize_dyn(mids_s[:, None, :], X[:, :-1], U)
    B = B * cost_b.agent_mask[:, None, :, None, None]
    return A.contiguous(), B.contiguous()


# ---------------------------------------------------------------------------
# Kernel 1: batched backward pass.
# ---------------------------------------------------------------------------


def _gj_solve_torch(Quu, Qux, Qu):
    """Gauss-Jordan ``Quu [X | x] = [Qux | Qu]`` without pivoting, batched
    over the leading axis; the elimination order, reciprocal-multiply pivots
    and pivot-row restore of the kernel."""
    nuf = Quu.shape[-1]
    for kp in range(nuf):
        inv = 1.0 / Quu[:, kp, kp]
        pivq = Quu[:, kp, :] * inv[:, None]
        pivx = Qux[:, kp, :] * inv[:, None]
        pivu = Qu[:, kp] * inv
        col = Quu[:, :, kp]
        Quu = Quu - col[:, :, None] * pivq[:, None, :]
        Qux = Qux - col[:, :, None] * pivx[:, None, :]
        Qu = Qu - col * pivu[:, None]
        Quu[:, kp, :] = pivq
        Qux[:, kp, :] = pivx
        Qu[:, kp] = pivu
    return Qux, Qu


def backward_pass_batched_torch(A, B, L_uu, L_xx, L_x, L_u, mu, p0, P0):
    """Plain PyTorch twin of the backward kernel (same inputs, outputs and
    memory layout as ``backward_pass_batched_cuda``)."""
    S, N, K, nx_p, _ = A.shape
    nu_p = B.shape[-1]
    nxf, nuf = K * nx_p, K * nu_p
    eye = torch.eye(nxf, dtype=A.dtype, device=A.device)
    p, P = p0, P0
    Kg = A.new_empty((S, N, nuf, nxf))
    d = A.new_empty((S, N, nuf))
    for t in range(N - 1, -1, -1):
        A_t, B_t = A[:, t], B[:, t]
        Preg = P + mu[:, None, None] * eye
        p2 = p.view(S, K, nx_p)
        Q_x = L_x[:, t] + torch.einsum("skba,skb->ska", A_t, p2).reshape(S, nxf)
        Q_u = L_u[:, t] + torch.einsum("skba,skb->ska", B_t, p2).reshape(S, nuf)
        AtP = torch.einsum(
            "skba,skbc->skac", A_t, P.view(S, K, nx_p, nxf)
        ).reshape(S, nxf, nxf)
        Q_xx = L_xx[:, t] + torch.einsum(
            "srkb,skba->srka", AtP.view(S, nxf, K, nx_p), A_t
        ).reshape(S, nxf, nxf)
        W1 = torch.einsum(
            "skbj,skbc->skjc", B_t, Preg.view(S, K, nx_p, nxf)
        ).reshape(S, nuf, nxf)
        W1k = W1.view(S, nuf, K, nx_p)
        Q_ux = torch.einsum("srkb,skba->srka", W1k, A_t).reshape(S, nuf, nxf)
        Q_uu = torch.einsum("srkb,skbj->srkj", W1k, B_t).reshape(S, nuf, nuf)
        Q_uu = Q_uu + L_uu[:, t]

        sol_K, sol_d = _gj_solve_torch(Q_uu, Q_ux, Q_u)
        K_t, d_t = -sol_K, -sol_d
        Kg[:, t], d[:, t] = K_t, d_t

        # Full-form value update with symmetrization (control.py:144-146).
        w = torch.einsum("svj,sv->sj", Q_uu, d_t) + Q_u
        p = (
            Q_x
            + torch.einsum("svc,sv->sc", K_t, w)
            + torch.einsum("svc,sv->sc", Q_ux, d_t)
        )
        QuuK = torch.einsum("svi,svj->sij", Q_uu, K_t)
        KtQux = torch.einsum("svi,svj->sij", K_t, Q_ux)
        P_new = (
            Q_xx
            + torch.einsum("svi,svj->sij", K_t, QuuK)
            + KtQux
            + KtQux.transpose(1, 2)
        )
        P = 0.5 * (P_new + P_new.transpose(1, 2))
    return Kg.permute(_inverse(GAIN_ORDER)), d.permute(_inverse(D_ORDER))


def _check_width(name: str, K: int, nx_p: int, nu_p: int, itemsize: int,
                 narrow: bool = False):
    """Raise unless backward kernel ``name`` takes subproblems of ``K``
    slots: the narrow kernel up to ``MAX_NXF`` flat states and controls, its
    working set all in shared memory, the wide one whatever
    ``riccati_plan`` places (it raises, naming the plan, where no tier
    fits)."""
    nxf, nuf = K * nx_p, K * nu_p
    if narrow and max(nxf, nuf) > MAX_NXF:
        raise ValueError(
            f"{name} takes K*nx_p, K*nu_p <= {MAX_NXF}, got {nxf}, {nuf}: "
            "wider subproblems take backward_pass_batched_wide_cuda"
        )
    tier = riccati_plan(K, nx_p, nu_p, itemsize).tier
    if narrow and tier != 0:
        raise ValueError(f"{name}: a subproblem of K={K} does not fit shared memory")


@lru_cache(maxsize=64)
def _dt_tensor(dt: float, dtype, device):
    """The fleet's step as a one-value tensor on ``device``, made once."""
    return torch.tensor([dt], dtype=torch.float64).to(dtype).to(device)


def _backward_checks(kernel, narrow, fleet: Fleet, X, U):
    """The checks a backward launch makes before it allocates (each raises):
    the fleet's models, the kernel's width, the device; returns the library
    that runs the fleet (``require_kernel_models``)."""
    K, nx_p = X.shape[2], X.shape[3]
    nu_p = U.shape[-1]
    library = require_kernel_models(fleet)
    _check_width(kernel, K, nx_p, nu_p, X.element_size(), narrow)
    require_cuda(kernel, X)
    if fleet.nx_p != nx_p or fleet.nu_p != nu_p:
        raise ValueError("X/U widths do not match the fleet's nx_p/nu_p")
    return library


def _bind_backward(kernel, fleet: Fleet, cost_b: GameCost, mids_s, ids, dt, X, U,
                   mu, Kg, d, work, library):
    """Check a backward kernel's tensors, the outputs ``Kg (S, N, nuf,
    nxf)`` and ``d (S, N, nuf)`` in memory order and the ``work (S,
    values)`` its plan asks for (None for K1) among them, and bind its
    launch; ``ids`` and ``dt`` are the fleet's model ids and step on the
    device (``_model_tables``, ``_dt_tensor``)."""
    S, Np1, K, nx_p = X.shape
    N = Np1 - 1
    nu_p = U.shape[-1]
    nxf, nuf = K * nx_p, K * nu_p
    dtype, dev = X.dtype, X.device
    cost_b = cast_cost(cost_b, dtype)
    ins = dict(X=X, U=U, xf=cost_b.xf, Q=cost_b.Q, R=cost_b.R, Qf=cost_b.Qf,
               mask=cost_b.agent_mask, refw=cost_b.ref_weight,
               radius=cost_b.radius, proxw=cost_b.prox_weight, npos=cost_b.n_pos,
               mids=mids_s.to(torch.int32), ids=ids, dt=dt, mu=mu)
    check_tensors(kernel, {**ins, "Kg": Kg, "d": d}, dict(
        X=(S, N + 1, K, nx_p), U=(S, N, K, nu_p), xf=(S, K, nx_p),
        Q=(S, K, nx_p, nx_p), R=(S, K, nu_p, nu_p), Qf=(S, K, nx_p, nx_p),
        mask=(S, K), refw=(S,), radius=(S,), proxw=(S,), npos=(S, K),
        mids=(S, K), ids=(len(fleet.unique_specs),), dt=(1,), mu=(S,),
        Kg=(S, N, nuf, nxf), d=(S, N, nuf)),
        dtype, dev, ints=("npos", "mids", "ids"))
    extra = () if work is None else (work, work.numel())
    return bind(kernel, dtype, *ins.values(), Kg, d, *extra, S, N, K, nx_p, nu_p,
                library=library, tier=_backward_plan(kernel, K, nx_p, nu_p,
                                                     X.element_size()).tier)


def _backward_plan(kernel: str, K: int, nx_p: int, nu_p: int, itemsize: int) -> RiccatiPlan:
    """The library's plan for backward kernel ``kernel`` (K1 or K3): K3's
    may put a subproblem on a cluster of CTAs."""
    return riccati_plan(K, nx_p, nu_p, itemsize,
                        cluster_max() if kernel == "backward_batched_wide" else 1)


def _launch_backward(kernel, narrow, fleet: Fleet, cost_b: GameCost, mids_s, X, U,
                     mu, workspace=False):
    """Check the backward inputs and launch ``kernel`` (with the
    per-subproblem device-memory ``workspace`` its plan asks for); returns
    ``Kg (N, nuf, nxf, S)``, ``d (N, nuf, S)``, views of ``(S, N, nuf,
    nxf)`` and ``(S, N, nuf)`` memory."""
    library = _backward_checks(kernel, narrow, fleet, X, U)
    S, Np1, K, nx_p = X.shape
    nu_p = U.shape[-1]
    nxf, nuf = K * nx_p, K * nu_p
    dtype, dev = X.dtype, X.device
    specs = fleet.unique_specs
    ids = _model_tables(specs, fleet.dt, dtype, dev, tuple(s.expr for s in specs))[0]
    Kg = X.new_empty((S, Np1 - 1, nuf, nxf))
    d = X.new_empty((S, Np1 - 1, nuf))
    work = (X.new_empty((S, _backward_plan(kernel, K, nx_p, nu_p, X.element_size()).work))
            if workspace else None)
    run(_bind_backward(kernel, fleet, cost_b, mids_s, ids,
                       _dt_tensor(fleet.dt, dtype, dev), X, U, mu, Kg, d, work,
                       library), dev)
    return Kg.permute(_inverse(GAIN_ORDER)), d.permute(_inverse(D_ORDER))


def backward_pass_batched_cuda(fleet: Fleet, cost_b: GameCost, mids_s, X, U, mu):
    """Launch ``csrc/backward_batched.cu`` (K * nx_p <= 32): the whole
    backward pass of every subproblem, one CTA each, its inputs (the
    Euler-discretized Jacobians of each slot's model, the cost's gradients
    and Hessian blocks) computed in the kernel from the trajectory ``X (S,
    N+1, K, nx_p)``, ``U (S, N, K, nu_p)``, the per-subproblem cost
    ``cost_b`` and the slots' branch indices ``mids_s (S, K)``, with
    regularization ``mu (S,)``.  Returns ``Kg (N, nuf, nxf, S)``, ``d (N,
    nuf, S)``.  Its plain version: ``backward_pass_batched`` with backend
    "torch"."""
    return _launch_backward("backward_batched", True, fleet, cost_b, mids_s, X, U,
                            mu)


def backward_pass_batched_wide_cuda(fleet: Fleet, cost_b: GameCost, mids_s, X, U,
                                    mu):
    """Launch ``csrc/backward_batched_wide.cu`` (any width the card places):
    the same contract as ``backward_pass_batched_cuda``.  Each subproblem's
    working set lies in shared memory where it fits (``riccati_plan`` with
    ``cluster_max()``), else its three nxf^2 matrices in a device-memory
    workspace, else where a cluster of at most ``cluster_max()`` CTAs holds
    it all in their shared memory on such a cluster (Quad6D at K=32 in
    float32), else its gain blocks and input buffers in the workspace too;
    it raises where not even the vectors fit, or where the card cannot
    place a cluster."""
    return _launch_backward("backward_batched_wide", False, fleet, cost_b, mids_s,
                            X, U, mu, workspace=True)


def backward_pass_batched(
    fleet: Fleet, cost_b: GameCost, mids_s, X, U, mu, backend: str = "auto"
):
    """Batched Riccati sweep (reference control.py:116-148).

    ``X (S, N+1, K, nx_p)``, ``U (S, N, K, nu_p)``, ``mu (S,)``,
    ``mids_s (S, K)`` per-slot branch indices.  Returns ``Kg (N, nuf, nxf,
    S)`` and ``d (N, nuf, S)``, the JAX package's layout.  On the kernels
    it is one launch (the kernel computes its inputs), flat states up to 32
    wide on the narrow kernel and wider ones on the wide one (the JAX
    package's routing, pallas_batched.py:989-1001, which past 96 falls to
    its XLA scans; here the wide kernel goes on).  The plain version
    computes the inputs in torch (``_quadraticize_batch``,
    ``_linearize_batch``) and runs ``backward_pass_batched_torch``.
    """
    mu = mu.to(X.dtype).contiguous()
    if resolve_backend(backend, X) == "torch":
        q = _quadraticize_batch(cost_b, X, U)
        A, B = _linearize_batch(fleet, cost_b, mids_s, X, U)
        return backward_pass_batched_torch(A, B, q["L_uu"], q["L_xx"], q["L_x"],
                                           q["L_u"], mu, q["p0"], q["P0"])
    fn = (backward_pass_batched_cuda if X.shape[2] * X.shape[3] <= MAX_NXF
          else backward_pass_batched_wide_cuda)
    return fn(fleet, cost_b, mids_s, X, U, mu)


# ---------------------------------------------------------------------------
# Kernel 2: batched forward pass (line search over all alphas).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def _model_tables(unique_specs, dt: float, dtype, device, forms=None):
    """``(model id, RK4 substeps, step dh = dt / substeps)`` of each unique
    model, on ``device``: built once per (models, dt, dtype, device), since a
    tensor made from a Python list is a pageable copy that waits for the
    stream.  The ids are those of the library that runs the models
    (``codegen.library_ids``: a custom field's library-local id); ``forms``,
    the specs' sympy forms, only keys the cache (equal specs may carry two)."""
    ids = torch.tensor(library_ids(unique_specs), dtype=torch.int32, device=device)
    nsub = torch.tensor([s.rk4_substeps for s in unique_specs], dtype=torch.int32,
                        device=device)
    dh = torch.tensor([dt / s.rk4_substeps for s in unique_specs],
                      dtype=torch.float64, device=device).to(dtype)
    return ids, nsub, dh


def _slot_tables(fleet: Fleet, mids_s, dtype):
    """Per-slot ``(model id, RK4 substeps, step dh = dt / substeps)`` from
    the branch indices ``mids_s (S, K)``."""
    specs = fleet.unique_specs
    ids, nsub, dh = _model_tables(specs, fleet.dt, dtype, mids_s.device,
                                  tuple(s.expr for s in specs))
    m = mids_s.long()
    return ids[m], nsub[m], dh[m]


def _skip_tail(tail) -> bool:
    """The tail's predicate turned round: True where no active subproblem
    needs the tail alphas (every one improved at a probe alpha).  ``tail``
    is ``(J_probe (p, S), J (S), active (S))``."""
    J_probe, J, active = tail
    return not bool(torch.any(active & ~torch.any(J_probe < J[None, :], dim=0)))


def forward_pass_batched_torch(fleet: Fleet, cost_b: GameCost, mids_s, X, U,
                               Kg, d, alphas, tail=None):
    """Plain PyTorch twin of the forward kernel (same arguments, outputs and
    memory layout as ``forward_pass_batched``).  With ``tail`` (the probe's
    ``J_probe (p, S)``, the carry's ``J (S)`` and ``active (S)``) it is the
    twin of the tail launch: where no active subproblem needs the tail
    (``_skip_tail``) it returns the JAX package's skip branch
    (pallas_batched.py:1035-1043): zero candidates and J = +inf."""
    S, Np1, K, nx_p = X.shape
    N = Np1 - 1
    nu_p = U.shape[-1]
    n_alpha = alphas.shape[0]
    if tail is not None and _skip_tail(tail):
        inv = _inverse(COLUMN_ORDER)
        return (X.new_zeros((n_alpha, S, N, K, nx_p)).permute(inv),
                X.new_zeros((n_alpha, S, N, K, nu_p)).permute(inv),
                X.new_full((n_alpha, S), float("inf")))
    _, nsub, dh_slot = _slot_tables(fleet, mids_s, X.dtype)
    n_steps = int(max(s.rk4_substeps for s in fleet.unique_specs))
    # dh_table[i] = dh for substep i < the slot's own count, else exactly 0
    # (x + 0 * (...) == x, so each slot runs its own RK4 schedule).
    dh_tab = [
        torch.where(nsub > i, dh_slot, torch.zeros_like(dh_slot))[..., None]
        for i in range(n_steps)
    ]
    f = blended_f(fleet.specs)
    mids = mids_s.long()
    cost_b = cast_cost(cost_b, X.dtype)

    x = X[:, 0].expand(n_alpha, S, K, nx_p)
    J = X.new_zeros((n_alpha, S))
    a4 = alphas.to(X.dtype)[:, None, None, None]
    Xs, Us = [], []
    for t in range(N):
        if Kg is not None:
            dx = (x - X[:, t]).reshape(n_alpha, S, K * nx_p)
            du = torch.einsum("rcs,asc->asr", Kg[t], dx)
            u = (
                U[:, t]
                + du.reshape(n_alpha, S, K, nu_p)
                + a4 * d[t].T.reshape(S, K, nu_p)
            )
        else:
            u = U[:, t].expand(n_alpha, S, K, nu_p)
        J = J + stage_cost(cost_b, x, u)
        Us.append(u)
        for dh in dh_tab:
            k0 = f(x, u, mids)
            k1 = f(x + 0.5 * dh * k0, u, mids)
            k2 = f(x + 0.5 * dh * k1, u, mids)
            k3 = f(x + dh * k2, u, mids)
            x = x + dh * (k0 + 2.0 * k1 + 2.0 * k2 + k3) / 6.0
        Xs.append(x)
    J = J + terminal_cost(cost_b, x)
    # Column-major memory (n_alpha, S, N, K, nx_p), public (N, nx_p, K, n_alpha, S).
    X5 = torch.stack(Xs, dim=2).permute(_inverse(COLUMN_ORDER))
    U5 = torch.stack(Us, dim=2).permute(_inverse(COLUMN_ORDER))
    return X5, U5, J


def _bind_forward(fleet: Fleet, cost_b: GameCost, tables, X, U, Kg, d, alphas, X5,
                  U5, J, library, max_rows: int = 0, tail=None):
    """Check K2's tensors and bind its launch: ``tables`` the per-slot
    ``(model id, RK4 substeps, dh)`` (``_slot_tables``), ``Kg (N, nuf, nxf,
    S)`` and ``d (N, nuf, S)`` views of the kernel's memory order (or None),
    the outputs ``X5 (n_alpha, S, N, K, nx_p)``, ``U5 (n_alpha, S, N, K,
    nu_p)`` and ``J (n_alpha, S)`` contiguous, and with ``tail`` the
    predicate's ``(J_probe (p, S), J (S), active (S))``."""
    S, Np1, K, nx_p = X.shape
    N = Np1 - 1
    nu_p = U.shape[-1]
    nxf, nuf = K * nx_p, K * nu_p
    n_alpha = alphas.shape[0]
    dtype, dev = X.dtype, X.device
    model, nsub, dh = tables
    ins = dict(X=X, U=U, Kg=Kg, d=d, alphas=alphas, model=model, nsub=nsub,
               dh=dh, xf=cost_b.xf, Q=cost_b.Q, R=cost_b.R, Qf=cost_b.Qf,
               mask=cost_b.agent_mask, refw=cost_b.ref_weight,
               radius=cost_b.radius, proxw=cost_b.prox_weight,
               npos_eval=cost_b.n_pos_eval)
    outs = dict(X5=X5, U5=U5, J=J)
    pred = dict(zip(("J_probe", "J_carry", "active"), tail or (None,) * 3))
    n_probe = 0 if tail is None else tail[0].shape[0]
    shapes = dict(X=(S, N + 1, K, nx_p), U=(S, N, K, nu_p),
                  Kg=(N, nuf, nxf, S), d=(N, nuf, S), alphas=(n_alpha,),
                  model=(S, K), nsub=(S, K), dh=(S, K), xf=(S, K, nx_p),
                  Q=(S, K, nx_p, nx_p), R=(S, K, nu_p, nu_p),
                  Qf=(S, K, nx_p, nx_p), mask=(S, K), refw=(S,), radius=(S,),
                  proxw=(S,), npos_eval=(S, K), X5=(n_alpha, S, N, K, nx_p),
                  U5=(n_alpha, S, N, K, nu_p), J=(n_alpha, S),
                  J_probe=(n_probe, S), J_carry=(S,), active=(S,))
    check_tensors("forward_batched",
                  {k: v for k, v in {**ins, **outs, **pred}.items() if v is not None},
                  shapes, dtype, dev, ints=("model", "nsub", "npos_eval"),
                  bools=("active",), layouts={"Kg": GAIN_ORDER, "d": D_ORDER})
    return bind("forward_batched", dtype, *ins.values(), *outs.values(),
                *pred.values(), S, N, K, nx_p, nu_p, n_alpha, max_rows, n_probe,
                library=library)


def forward_pass_batched_cuda(fleet: Fleet, cost_b: GameCost, mids_s, X, U,
                              Kg, d, alphas, max_rows: int = 0, out=None,
                              tail=None):
    """Launch ``csrc/forward_batched.cu``: a CTA per subproblem, a warp per
    alpha.  Same arguments and outputs as ``forward_pass_batched``.  Gains
    that do not lie in the kernel's memory order (``GAIN_ORDER``,
    ``D_ORDER``: what the backward wrappers and twins return) are copied
    into it once.  ``max_rows`` > 0 forces the gain block into tiles of at
    most that many rows (``forward_plan``), which must give the bits
    of the whole block: for the tests and the smoke.  ``out``: the
    ``(X5, U5, J)`` buffers to write, contiguous ``(n_alpha, S, N, K,
    nx_p)``, ``(n_alpha, S, N, K, nu_p)`` and ``(n_alpha, S)``; ``tail``:
    the predicate's ``(J_probe, J, active)`` (``forward_pass_batched_torch``),
    under which the launch writes J = +inf and nothing else where no active
    subproblem needs these alphas."""
    S, Np1, K, nx_p = X.shape
    N = Np1 - 1
    nu_p = U.shape[-1]
    n_alpha = alphas.shape[0]
    library = require_kernel_models(fleet)
    forward_plan(K, nx_p, nu_p, n_alpha, X.element_size(),
                 gains=Kg is not None)  # raises where nothing fits
    require_cuda("forward_batched", X)
    if fleet.nx_p != nx_p or fleet.nu_p != nu_p:
        raise ValueError("X/U widths do not match the fleet's nx_p/nu_p")
    dtype, dev = X.dtype, X.device
    tables = _slot_tables(fleet, mids_s, dtype)
    if Kg is not None:
        Kg, d = as_layout(Kg, GAIN_ORDER), as_layout(d, D_ORDER)
    if out is None:
        out = (X.new_empty((n_alpha, S, N, K, nx_p)),
               X.new_empty((n_alpha, S, N, K, nu_p)), X.new_empty((n_alpha, S)))
    X5, U5, J = out
    run(_bind_forward(fleet, cost_b, tables, X, U, Kg, d, alphas, X5, U5, J, library,
                      max_rows, tail), dev)
    return (X5.permute(_inverse(COLUMN_ORDER)),
            U5.permute(_inverse(COLUMN_ORDER)), J)


def forward_pass_batched(
    fleet: Fleet, cost_b: GameCost, mids_s, X, U, Kg, d, alphas,
    backend: str = "auto",
):
    """Batched closed-loop forward sweep (control.py:95-114).

    ``X (S, N+1, K, nx_p)``, ``U (S, N, K, nu_p)`` nominal trajectory;
    ``Kg (N, nuf, nxf, S)``, ``d (N, nuf, S)`` from
    ``backward_pass_batched`` (None for a plain rollout of U); ``alphas
    (n_alpha,)``; ``mids_s (S, K)`` per-slot branch indices; ``cost_b``
    fields in X's dtype.

    Returns ``X5 (N, nx_p, K, n_alpha, S)`` (states 1..N), ``U5 (N, nu_p,
    K, n_alpha, S)``, views of column-major memory (``COLUMN_ORDER``), and
    ``J (n_alpha, S)``.
    """
    fn = (
        forward_pass_batched_cuda
        if resolve_backend(backend, X) == "cuda"
        else forward_pass_batched_torch
    )
    return fn(fleet, cost_b, mids_s, X, U, Kg, d, alphas)


def line_search_batched(fleet: Fleet, cfg: SolverConfig, sub_cost: GameCost, mids_s,
                        X, U, Kg, d, J, active, backend: str = "auto"):
    """The line search of one iteration over ``cfg.n_ls_iter`` alphas:
    ``X5``, ``U5`` (public shapes, column-major memory) and ``J_c
    (n_alpha, S)``.  Two-stage where ``0 < cfg.ls_probe < n_alpha``: the
    first ``ls_probe`` alphas, then the rest under the tail's predicate
    (given the carry's ``J`` and ``active``).  On the kernels both launches
    always run, into one buffer of all the alphas; no host sync decides
    (the counterpart of the ``lax.cond`` at pallas_batched.py:1045).  The
    twins join their two candidate sets."""
    n_alpha, p = cfg.n_ls_iter, cfg.ls_probe
    alphas = line_search_alphas(n_alpha, X.dtype, X.device)
    if not 0 < p < n_alpha:
        return forward_pass_batched(fleet, sub_cost, mids_s, X, U, Kg, d, alphas,
                                    backend)
    if resolve_backend(backend, X) == "cuda":
        S, Np1, K, nx_p = X.shape
        X5 = X.new_empty((n_alpha, S, Np1 - 1, K, nx_p))
        U5 = X.new_empty((n_alpha, S, Np1 - 1, K, U.shape[-1]))
        J_c = X.new_empty((n_alpha, S))
        forward_pass_batched_cuda(fleet, sub_cost, mids_s, X, U, Kg, d, alphas[:p],
                                  out=(X5[:p], U5[:p], J_c[:p]))
        forward_pass_batched_cuda(fleet, sub_cost, mids_s, X, U, Kg, d, alphas[p:],
                                  out=(X5[p:], U5[p:], J_c[p:]),
                                  tail=(J_c[:p], J, active))
        inv = _inverse(COLUMN_ORDER)
        return X5.permute(inv), U5.permute(inv), J_c
    X5, U5, J_a = forward_pass_batched_torch(fleet, sub_cost, mids_s, X, U, Kg, d,
                                             alphas[:p])
    X5b, U5b, J_b = forward_pass_batched_torch(fleet, sub_cost, mids_s, X, U, Kg, d,
                                               alphas[p:], tail=(J_a, J, active))
    return _cat_alphas(X5, X5b), _cat_alphas(U5, U5b), torch.cat([J_a, J_b], dim=0)


def select_alpha(X5, U5, x0_s, a_idx):
    """Each subproblem's accepted line-search candidate.

    ``X5 (N, nx_p, K, n_alpha, S)``, ``a_idx (S,)`` -> ``X (S, N+1, K,
    nx_p)`` with ``x0_s (S, K, nx_p)`` prepended, ``U (S, N, K, nu_p)``.
    A candidate is one contiguous row of the column-major memory, so the
    gather moves whole trajectories.
    """
    S = X5.shape[-1]
    a = a_idx.long()
    s = torch.arange(S, device=X5.device)
    Xsel = X5.permute(COLUMN_ORDER)[a, s]  # (S, N, K, nx_p)
    Usel = U5.permute(COLUMN_ORDER)[a, s]
    return torch.cat([x0_s[:, None], Xsel], dim=1), Usel.contiguous()


def _cat_alphas(a, b):
    """Two candidate sets ``(N, n, K, n_alpha_i, S)`` joined along the alpha
    axis, in column-major memory."""
    cols = torch.cat([a.permute(COLUMN_ORDER), b.permute(COLUMN_ORDER)], dim=0)
    return cols.permute(_inverse(COLUMN_ORDER))


# ---------------------------------------------------------------------------
# Batched iLQR solve driver.
# ---------------------------------------------------------------------------


class BatchCarry(NamedTuple):
    X: torch.Tensor  # (S, N+1, K, nx_p)
    U: torch.Tensor  # (S, N, K, nu_p)
    J: torch.Tensor  # (S,)
    mu: torch.Tensor  # (S,)
    delta: torch.Tensor  # (S,)
    i: torch.Tensor  # (S,) int32
    converged: torch.Tensor  # (S,) bool
    failed: torch.Tensor  # (S,) bool
    active: torch.Tensor  # (S,) bool


def init_batch_carry(
    fleet: Fleet, cfg: SolverConfig, sub_cost: GameCost, x0_s, U0_s, mids_s,
    enabled, backend: str = "auto",
) -> BatchCarry:
    """Initial rollout of the warm start (control.py:80-93) + carry setup;
    the rollout is the forward kernel with no gains and one alpha."""
    dtype, dev = x0_s.dtype, x0_s.device
    S, K, nx_p = x0_s.shape
    N = U0_s.shape[1]
    X0full = x0_s[:, None].expand(S, N + 1, K, nx_p).contiguous()
    X5, U5, J1 = forward_pass_batched(
        fleet, sub_cost, mids_s, X0full, U0_s, None, None,
        torch.zeros((1,), dtype=dtype, device=dev), backend,
    )
    zeros_i = torch.zeros((S,), dtype=torch.int32, device=dev)
    Xr, Ur = select_alpha(X5, U5, x0_s, zeros_i)
    no = torch.zeros((S,), dtype=torch.bool, device=dev)
    return BatchCarry(
        X=Xr, U=Ur, J=J1[0],
        mu=torch.full((S,), cfg.mu_init, dtype=dtype, device=dev),
        delta=torch.full((S,), cfg.delta_0, dtype=dtype, device=dev),
        i=zeros_i, converged=no, failed=no.clone(),
        active=enabled.to(torch.bool) & (cfg.n_lqr_iter > 0),
    )


def accept_batched_torch(cfg: SolverConfig, X5, U5, J_c, x0_s, c: BatchCarry,
                         counter=None):
    """Plain PyTorch version of ``csrc/accept_batched.cu``: the accept step
    of one iteration (reference control.py:150-237), per subproblem the
    first improving candidate of ``X5 (N, nx_p, K, n_alpha, S)``, ``U5``
    and ``J_c (n_alpha, S)``, regularization and convergence, inactive
    subproblems frozen.  Updates the carry ``c`` in place, as the kernel
    does; with ``counter`` (int32 (2,)) writes the active count to
    ``counter[0]``.  It runs on the CPU and in the tests; the card's path
    runs the kernel."""
    dtype = x0_s.dtype
    improved = J_c < c.J[None, :]  # (n_alpha, S)
    accept = torch.any(improved, dim=0)
    a_idx = torch.argmax(improved.to(torch.int32), dim=0)  # first improving
    Xn, Un = select_alpha(X5, U5, x0_s, a_idx)
    Jn = J_c.gather(0, a_idx[None])[0]

    upd = c.active & accept
    X = torch.where(upd[:, None, None, None], Xn, c.X)
    U = torch.where(upd[:, None, None, None], Un, c.U)
    J = torch.where(upd, Jn, c.J)

    tiny = torch.finfo(dtype).tiny
    rel = torch.abs((c.J - Jn) / torch.clamp(torch.abs(c.J), min=tiny))
    converged_now = upd & (rel < cfg.tol)
    failed_now = c.active & ~accept

    # Regularization decrease on acceptance (control.py:232-237).
    delta_dec = torch.clamp(c.delta, max=1.0) / cfg.delta_0
    mu_dec = c.mu * delta_dec
    mu_lo = cfg.mu_min if cfg.mu_floor else 0.0
    mu_dec = torch.where(mu_dec <= cfg.mu_min, torch.full_like(mu_dec, mu_lo), mu_dec)
    if cfg.on_failed_ls == "increase":
        # The reference's (dead) mu-increase path (control.py:198-208).
        delta_inc = torch.clamp(c.delta, min=1.0) * cfg.delta_0
        mu_inc = torch.clamp(c.mu * delta_inc, min=cfg.mu_min)
        mu = torch.where(upd, mu_dec, torch.where(c.active, mu_inc, c.mu))
        delta = torch.where(upd, delta_dec, torch.where(c.active, delta_inc, c.delta))
        failed_now = failed_now & (mu_inc >= cfg.mu_max)
    else:
        mu = torch.where(upd, mu_dec, c.mu)
        delta = torch.where(upd, delta_dec, c.delta)

    i = c.i + c.active.to(torch.int32)
    converged = c.converged | converged_now
    failed = c.failed | failed_now
    active = c.active & ~converged_now & ~failed_now & (i < cfg.n_lqr_iter)
    for dst, src in zip(c, (X, U, J, mu, delta, i, converged, failed, active)):
        dst.copy_(src)
    if counter is not None:
        counter[0] = active.sum()


def _bind_accept(cfg: SolverConfig, X5, U5, J_c, x0_s, c: BatchCarry, counter):
    """Check the accept kernel's tensors (``X5 (n_alpha, S, N, K, nx_p)``
    and ``U5`` contiguous, the kernel's memory) and bind its launch."""
    n_alpha, S, N, K, nx_p = X5.shape
    nu_p = U5.shape[-1]
    dtype, dev = x0_s.dtype, x0_s.device
    ins = dict(X5=X5, U5=U5, J_c=J_c, x0=x0_s, X=c.X, U=c.U, J=c.J, mu=c.mu,
               delta=c.delta, i=c.i, converged=c.converged, failed=c.failed,
               active=c.active, counter=counter)
    check_tensors("accept_batched", ins, dict(
        X5=(n_alpha, S, N, K, nx_p), U5=(n_alpha, S, N, K, nu_p), J_c=(n_alpha, S),
        x0=(S, K, nx_p), X=(S, N + 1, K, nx_p), U=(S, N, K, nu_p), J=(S,), mu=(S,),
        delta=(S,), i=(S,), converged=(S,), failed=(S,), active=(S,), counter=(2,)),
        dtype, dev, ints=("i", "counter"), bools=("converged", "failed", "active"))
    return bind("accept_batched", dtype, *ins.values(), S, N, K, nx_p, nu_p, n_alpha,
                float(cfg.tol), float(cfg.mu_min), float(cfg.mu_max),
                float(cfg.delta_0), int(cfg.mu_floor), int(cfg.on_failed_ls == "increase"),
                int(cfg.n_lqr_iter))


def accept_batched_cuda(cfg: SolverConfig, X5, U5, J_c, x0_s, c: BatchCarry,
                        counter=None):
    """Launch ``csrc/accept_batched.cu``: ``accept_batched_torch``'s contract
    and bits, one CTA per subproblem; ``counter`` (int32 (2,), its second
    value 0) is allocated where not given."""
    require_cuda("accept_batched", x0_s)
    if counter is None:
        counter = torch.zeros((2,), dtype=torch.int32, device=x0_s.device)
    run(_bind_accept(cfg, X5.permute(COLUMN_ORDER), U5.permute(COLUMN_ORDER), J_c,
                     x0_s, c, counter), x0_s.device)


def accept_batched(cfg: SolverConfig, X5, U5, J_c, x0_s, c: BatchCarry,
                   backend: str = "auto"):
    """The accept step (``accept_batched_torch``): the kernel on CUDA
    tensors, the plain version on CPU tensors; the carry ``c`` is updated
    in place."""
    cuda = resolve_backend(backend, x0_s) == "cuda"
    (accept_batched_cuda if cuda else accept_batched_torch)(cfg, X5, U5, J_c, x0_s, c)


def batched_iteration(
    fleet: Fleet, cfg: SolverConfig, sub_cost: GameCost, mids_s, x0_s,
    c: BatchCarry, backend: str = "auto",
) -> BatchCarry:
    """One iLQR iteration over the batch, eagerly: backward sweep, (two-stage)
    line search (``line_search_batched``), per-subproblem accept /
    regularization / convergence (``accept_batched``; reference
    control.py:150-226), inactive subproblems frozen.  Returns a new carry
    (``c`` is left as it was).  On the card ``solve_subproblems_batched``
    replays the same launches as a CUDA graph (``IterationGraph``); this
    eager form is the torch backend's iteration and the kernels' reference
    for the graph's bits."""
    Kg, dv = backward_pass_batched(
        fleet, sub_cost, mids_s, c.X, c.U, c.mu, backend
    )
    X5, U5, J_c = line_search_batched(fleet, cfg, sub_cost, mids_s, c.X, c.U, Kg, dv,
                                      c.J, c.active, backend)
    c = BatchCarry(*(a.clone() for a in c))
    accept_batched(cfg, X5, U5, J_c, x0_s, c, backend=backend)
    return c


# ---------------------------------------------------------------------------
# The iteration as a CUDA graph.
# ---------------------------------------------------------------------------

# The captured iterations kept across calls, least recently used first out
# past either bound (entries, and bytes of their buffers).
GRAPH_CACHE_ENTRIES = 32
GRAPH_CACHE_BYTES = 4 << 30
_graphs: OrderedDict = OrderedDict()
# The cache's lookups since the process started or ``reset_graph_cache_counts``:
# a hit finds the key's graph, a miss makes one (captured at its first step),
# an eviction drops the least recently used.
_graph_counts = dict(hits=0, misses=0, evictions=0)


def reset_graph_cache_counts():
    for k in _graph_counts:
        _graph_counts[k] = 0


def graph_key(cfg: SolverConfig, S: int, N: int, K: int, nx_p: int, nu_p: int,
              n_specs: int, dtype, device, library: str | None) -> tuple:
    """The cache key of a captured iteration: every shape its buffers and
    launches have (the width ``S``, ``N``, ``K``, ``nx_p``, ``nu_p``, the
    alphas and the probe's split, the fleet's number of distinct models),
    the type and the device, the kernels' library (default, or a custom
    build's header) and every ``SolverConfig`` value the accept kernel's
    launch bakes in."""
    return (S, N, K, nx_p, nu_p, n_specs, dtype, torch.device(device), library,
            cfg.n_ls_iter, cfg.ls_probe, float(cfg.tol), float(cfg.mu_min),
            float(cfg.mu_max), float(cfg.delta_0), bool(cfg.mu_floor),
            cfg.on_failed_ls, int(cfg.n_lqr_iter))


def _capture(launches, device):
    """Capture ``launches`` (bound, run once already) as a CUDA graph on
    ``device``; returns the graph and the bytes its capture allocated (its
    private pool: every buffer is allocated before, so none is expected).
    A failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    before = torch.cuda.memory_allocated(device)
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream(device)
        for b in launches:
            call(b, stream)
    return graph, torch.cuda.memory_allocated(device) - before


class IterationGraph:
    """One iteration of the batched solve at one width, over fixed buffers:
    K1 or K3, K2 for the probe alphas and K2 for the tail under its
    predicate (one K2 where ``ls_probe`` does not split the alphas), and the
    accept kernel, which updates the carry in place and writes the active
    count.  Every check, table and binding is made once, here; the first
    ``step`` launches the four eagerly (the warm-up, a real iteration) and
    captures them, every later one replays the graph.  ``load`` copies a
    stage's carry and data in."""

    def __init__(self, fleet: Fleet, cfg: SolverConfig, library, S, N, K, nx_p, nu_p,
                 dtype, device):
        nxf, nuf = K * nx_p, K * nu_p
        n_alpha, p = cfg.n_ls_iter, cfg.ls_probe

        def new(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        self.device = device
        self.carry = BatchCarry(
            X=new(S, N + 1, K, nx_p), U=new(S, N, K, nu_p), J=new(S), mu=new(S),
            delta=new(S), i=new(S, dt=torch.int32), converged=new(S, dt=torch.bool),
            failed=new(S, dt=torch.bool), active=new(S, dt=torch.bool))
        self.cost = GameCost(
            xf=new(S, K, nx_p), Q=new(S, K, nx_p, nx_p), R=new(S, K, nu_p, nu_p),
            Qf=new(S, K, nx_p, nx_p), radius=new(S), n_pos=new(S, K, dt=torch.int32),
            agent_mask=new(S, K), prox_weight=new(S), ref_weight=new(S),
            n_pos_eval=new(S, K, dt=torch.int32))
        self.mids, self.x0 = new(S, K, dt=torch.int32), new(S, K, nx_p)
        self.tables = (new(S, K, dt=torch.int32), new(S, K, dt=torch.int32), new(S, K))
        self.ids, self.dt = new(len(fleet.unique_specs), dt=torch.int32), new(1)
        self.alphas = line_search_alphas(n_alpha, dtype, device)
        self.Kg, self.d = new(S, N, nuf, nxf), new(S, N, nuf)
        narrow = nxf <= MAX_NXF  # backward_pass_batched's routing
        kernel = "backward_batched" if narrow else "backward_batched_wide"
        self.work = (None if narrow else
                     new(S, _backward_plan(kernel, K, nx_p, nu_p,
                                           self.x0.element_size()).work))
        self.X5, self.U5 = new(n_alpha, S, N, K, nx_p), new(n_alpha, S, N, K, nu_p)
        self.J_c = new(n_alpha, S)
        self.counter = torch.zeros((2,), dtype=torch.int32, device=device)

        c = self.carry
        Kg, d = self.Kg.permute(_inverse(GAIN_ORDER)), self.d.permute(_inverse(D_ORDER))

        def forward(lo, hi, tail=None):
            return _bind_forward(fleet, self.cost, self.tables, c.X, c.U, Kg, d,
                                 self.alphas[lo:hi], self.X5[lo:hi], self.U5[lo:hi],
                                 self.J_c[lo:hi], library, tail=tail)

        self.launches = [_bind_backward(kernel, fleet, self.cost, self.mids, self.ids,
                                        self.dt, c.X, c.U, c.mu, self.Kg, self.d,
                                        self.work, library)]
        if 0 < p < n_alpha:
            self.launches += [forward(0, p),
                              forward(p, n_alpha, (self.J_c[:p], c.J, c.active))]
        else:
            self.launches.append(forward(0, n_alpha))
        self.launches.append(_bind_accept(cfg, self.X5, self.U5, self.J_c, self.x0, c,
                                          self.counter))
        self.nbytes = sum(
            t.numel() * t.element_size()
            for t in (*self.carry, *self.cost, self.mids, self.x0, *self.tables,
                      self.ids, self.dt, self.alphas, self.Kg, self.d, self.work,
                      self.X5, self.U5, self.J_c, self.counter) if t is not None)
        self.graph, self.pool_bytes, self.capture_ms = None, 0, 0.0

    @property
    def data(self):
        return self.cost, self.mids, self.x0

    def load(self, fleet: Fleet, c: BatchCarry, data, perm=None):
        """Copy the carry ``c`` and the data ``(sub_cost, mids_s, x0_s)``
        into the buffers, gathered by ``perm`` where given (a compaction);
        then the slot tables and the fleet's model ids and step."""
        with span("dpilqr.batched.load"):
            src = (*c, *data[0], *data[1:])
            for dst, a in zip((*self.carry, *self.cost, self.mids, self.x0), src):
                dst.copy_(a if perm is None else a[perm])
            specs = fleet.unique_specs
            tabs = _model_tables(specs, fleet.dt, self.x0.dtype, self.device,
                                 tuple(s.expr for s in specs))
            m = self.mids.long()
            for dst, tab in zip(self.tables, tabs):
                dst.copy_(tab[m])
            self.ids.copy_(tabs[0])
            self.dt.copy_(_dt_tensor(fleet.dt, self.x0.dtype, self.device))

    def step(self) -> int:
        """One iteration; returns the active count after it (the one host
        sync).  Inside a ``timed_launches()`` block the four launches run
        one by one, each timed, in place of the replay."""
        if self.graph is None:
            with span("dpilqr.batched.capture"):
                for b in self.launches:
                    run(b, self.device)
                t0 = perf_counter()
                self.graph, self.pool_bytes = _capture(self.launches, self.device)
                self.capture_ms = (perf_counter() - t0) * 1e3
        else:
            with span("dpilqr.batched.replay"):
                if timing():
                    for b in self.launches:
                        run(b, self.device)
                else:
                    self.graph.replay()
                    for b in self.launches:
                        count(b)
        with span("dpilqr.batched.read"):
            return int(self.counter[0])


def iteration_graph(fleet: Fleet, cfg: SolverConfig, library, S, N, K, nx_p, nu_p,
                    dtype, device) -> IterationGraph:
    """The cached ``IterationGraph`` of this key (``graph_key``), made where
    there is none; the least recently used leave past ``GRAPH_CACHE_ENTRIES``
    or ``GRAPH_CACHE_BYTES``."""
    key = graph_key(cfg, S, N, K, nx_p, nu_p, len(fleet.unique_specs), dtype, device,
                    library)
    g = _graphs.pop(key, None)
    _graph_counts["misses" if g is None else "hits"] += 1
    if g is None:
        g = IterationGraph(fleet, cfg, library, S, N, K, nx_p, nu_p, dtype, device)
    _graphs[key] = g
    while len(_graphs) > 1 and (len(_graphs) > GRAPH_CACHE_ENTRIES
                                or graph_cache_info()["bytes"] > GRAPH_CACHE_BYTES):
        _graphs.popitem(last=False)
        _graph_counts["evictions"] += 1
    return g


def graph_cache_info() -> dict:
    """The graph cache: entries, of them captured, the bytes of their
    buffers, the bytes their captures allocated in the graphs' pools, the
    host milliseconds the captures took (each after its warm-up), and the
    lookups' ``hits``, ``misses`` and ``evictions`` (``_graph_counts``)."""
    gs = list(_graphs.values())
    return {"entries": len(gs), "captured": sum(g.graph is not None for g in gs),
            "bytes": sum(g.nbytes for g in gs), "pool_bytes": sum(g.pool_bytes for g in gs),
            "capture_ms": sum(g.capture_ms for g in gs), **_graph_counts}


class _EagerStage:
    """A width of the retirement loop run eagerly (``batched_iteration``):
    the torch backend's, and on the card the bits' reference."""

    def __init__(self, fleet, cfg, backend, c, data):
        self.fleet, self.cfg, self.backend = fleet, cfg, backend
        self.carry, self.data = c, data

    def step(self) -> int:
        self.carry = batched_iteration(self.fleet, self.cfg, *self.data, self.carry,
                                       self.backend)
        with span("dpilqr.batched.read"):
            return int(self.carry.active.sum())


def _eager_stage(fleet, cfg, backend, c, data, perm=None):
    if perm is not None:
        c = BatchCarry(*(a[perm] for a in c))
        data = (GameCost(*(a[perm] for a in data[0])), data[1][perm], data[2][perm])
    return _EagerStage(fleet, cfg, backend, c, data)


def _graph_stage(fleet, cfg, backend, c, data, perm=None):
    X = c.X
    S = X.shape[0] if perm is None else perm.shape[0]
    g = iteration_graph(fleet, cfg, require_kernel_models(fleet), S, X.shape[1] - 1,
                        X.shape[2], X.shape[3], c.U.shape[-1], X.dtype, X.device)
    g.load(fleet, c, data, perm)
    return g


def next_width(w: int, unit: int = COMPACTION_UNIT) -> int:
    """Next (smaller) compaction width: about half, rounded up to ``unit``;
    ``w`` itself when no smaller width exists."""
    nw = -(-(w // 2) // unit) * unit
    return nw if 0 < nw < w else w


def compaction_widths(S: int, unit: int = COMPACTION_UNIT) -> list[int]:
    """The halving width schedule ``[S, ~S/2, ..., final]``."""
    widths = [S]
    while (nw := next_width(widths[-1], unit)) != widths[-1]:
        widths.append(nw)
    return widths


def solve_subproblems_batched(
    fleet: Fleet, cfg: SolverConfig, sub_cost: GameCost, x0_s, U0_s, mids_s,
    enabled, backend: str | None = None, t_kill: float | None = None,
    t0: float | None = None, verbose: bool = False,
) -> SolveResult:
    """Batched iLQR over the subproblem axis.

    Same per-subproblem accept / regularization / convergence semantics as
    the reference's per-problem solve (control.py:150-226), applied
    elementwise with masked freezing.  Finished subproblems RETIRE: once the
    active count fits the next width of ``compaction_widths``, the actives
    are compacted (stable gather) and iteration continues at that width.  A
    subproblem's iteration sequence does not depend on its lane, so results
    equal the lockstep loop's.

    On the card each width's iteration is a CUDA graph (``IterationGraph``,
    cached across calls by ``graph_key``): the host replays it and reads the
    active count the accept kernel wrote, one sync an iteration.  A failed
    capture or launch raises.  The torch backend iterates eagerly.

    ``x0_s (S, K, nx_p)``, ``U0_s (S, N, K, nu_p)``, ``mids_s (S, K)`` branch
    indices, ``enabled (S,)`` bool; ``backend`` defaults to
    ``cfg.sweep_backend``.  On the kernels a width that K1's or K3's plan
    (``riccati_plan``) or K2's (``forward_plan``) does not place raises
    that plan's ``ValueError`` before any launch.

    ``t_kill`` (seconds) is the wall-clock deadline of the whole batch,
    counted from ``t0`` (a ``perf_counter`` reading; default: entry).  The
    host checks it after each iteration's active-count fetch, the sync that
    paces the loop, and once it has passed starts no further iteration: the
    best plan so far returns, with the unfinished subproblems neither
    converged nor failed.  Compaction keeps its schedule under a deadline.
    """
    with span("dpilqr.batched.solve"):
        if t0 is None:
            t0 = perf_counter()
        dtype = x0_s.dtype
        backend = resolve_backend(backend or cfg.sweep_backend, x0_s)
        if backend == "cuda":
            # A width the backward kernels' plan (K1, K3) or K2's does not place
            # raises its ValueError here, before any launch.
            K, item = x0_s.shape[1], x0_s.element_size()
            riccati_plan(K, fleet.nx_p, fleet.nu_p, item)
            forward_plan(K, fleet.nx_p, fleet.nu_p, cfg.n_ls_iter, item)
        stage = _graph_stage if backend == "cuda" else _eager_stage
        sub_cost = cast_cost(sub_cost, dtype)
        S = x0_s.shape[0]
        with span("dpilqr.batched.init"):
            c = init_batch_carry(fleet, cfg, sub_cost, x0_s, U0_s, mids_s, enabled,
                                 backend)
            out = BatchCarry(*(a.clone() for a in c))
            idx_map = torch.arange(S, device=x0_s.device)
        data = (sub_cost, mids_s, x0_s)
        w, perm = S, None
        with span("dpilqr.batched.read"):
            n_active = int(c.active.sum())  # host sync
        expired = False
        while True:
            nw = next_width(w)
            with span("dpilqr.batched.stage"):
                st = stage(fleet, cfg, backend, c, data, perm)
            while True:
                if n_active == 0:
                    break
                if t_kill is not None and perf_counter() - t0 > t_kill:
                    expired = True
                    if verbose:
                        print(f"t_kill reached after {int(st.carry.i.max())} iterations")
                    break
                if nw < w and n_active <= nw:
                    break
                n_active = st.step()  # host sync: paces the deadline
            c, data = st.carry, st.data
            with span("dpilqr.batched.scatter"):
                for o, a in zip(out, c):
                    o[idx_map] = a
            if n_active == 0 or expired or nw == w:
                break
            # Stable active-first permutation; keep the first nw lanes.
            with span("dpilqr.batched.compact"):
                perm = torch.argsort((~c.active).to(torch.uint8), stable=True)[:nw]
                idx_map = idx_map[perm]
            w = nw
        return SolveResult(
            X=out.X, U=out.U, J=out.J, iters=out.i, converged=out.converged,
            failed_line_search=out.failed,
        )
