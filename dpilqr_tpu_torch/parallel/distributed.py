"""Distributed (decomposed) solve: graph -> batched subproblems -> one solve.

Counterpart of ``dpilqr_tpu/parallel/distributed.py`` (reference
``solve_distributed``, distributed.py:25-103): the n per-agent subproblems
become one rectangular batch solved by ``solve_subproblems_batched`` (the
batched sweep kernels on CUDA tensors, their torch twins on CPU tensors);
each owner's rows are then scattered back and the stitched plan's joint
cost rolled out (``ops.ilqr.rollout``: the centralized forward kernel
without gains on CUDA tensors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DEFAULT_CONFIG, SolverConfig, resolve_device
from ..models.fleet import Fleet
from ..ops.batched import solve_subproblems_batched
from ..ops.costs import GameCost, cast_cost
from ..ops.ilqr import rollout
from ..utils.profiling import span
from .graph import interaction_graph
from .subproblems import (
    extract_owner,
    gather_controls,
    gather_cost,
    gather_states,
    gather_subproblems,
)


class DistributedResult(NamedTuple):
    X: torch.Tensor  # (N+1, n, nx_p) stitched owner trajectories
    U: torch.Tensor  # (N, n, nu_p) stitched owner controls
    J: torch.Tensor  # () joint cost of the stitched plan
    membership: torch.Tensor  # (n, n) bool interaction graph
    iters: torch.Tensor  # (n,) per-subproblem iLQR iterations
    converged: torch.Tensor  # (n,) per-subproblem convergence flags
    sizes: torch.Tensor  # (n,) neighborhood sizes
    # () bool: some neighborhood exceeded the slot count K, so coupling
    # partners were dropped (the reference never truncates); always False
    # under auto-K.
    truncated: torch.Tensor


def _width_from_kmax(k_max: int, n: int, n_max: int | None = None) -> int:
    """Max neighborhood size -> subproblem width: the next power of two."""
    K = 1 << (k_max - 1).bit_length() if k_max > 1 else 1
    return min(K, n if n_max is None else n_max)


def auto_subproblem_width(X, radius, cost: GameCost, graph_n_d=None,
                          n_max: int | None = None) -> int:
    """Subproblem width from the interaction graph (one host sync)."""
    X = X if X.ndim == 3 else X[None]
    M = interaction_graph(X, radius, n_pos=cost.n_pos, n_d=graph_n_d)
    return _width_from_kmax(int(M.sum(dim=1).max()), X.shape[1], n_max)


def solve_distributed(
    fleet: Fleet,
    cost: GameCost,
    X,
    U,
    radius,
    ignore_mask=None,
    K: int | None = None,
    graph_n_d: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
    t_kill: float | None = None,
    device=None,
) -> DistributedResult:
    """Solve by proximity decomposition.

    ``X (T, n, nx_p)`` is the previous trajectory used for the graph (its
    first row is the initial state), ``U (N, n, nu_p)`` the warm-start
    controls, ``radius`` the proximity radius.  ``ignore_mask (n,)`` bool
    marks agents whose subproblems are skipped (their stitched rows stay
    zero, like the reference's ``ignore_ids``).  ``K`` is the slot count;
    by default the maximum neighborhood size rounded up to a power of two.
    The solve runs in X's dtype; a tensor ``X`` keeps its device, numpy
    input goes to ``device`` (default: the card, ``config.default_device``).
    ``t_kill`` (seconds of wall clock, counted from entry) forwards to the
    deadline solve, ``parallel.deadline.solve_distributed_steppable``.
    """
    if t_kill is not None:
        from .deadline import solve_distributed_steppable

        return solve_distributed_steppable(
            fleet, cost, X, U, radius, ignore_mask=ignore_mask, K=K,
            graph_n_d=graph_n_d, config=config, t_kill=t_kill, device=device,
        )
    return _solve_decomposed(fleet, cost, X, U, radius, ignore_mask, K,
                             graph_n_d, config, device)


def _solve_decomposed(fleet, cost, X, U, radius, ignore_mask, K, graph_n_d,
                      config, device, t_kill=None, t0=None, verbose=False,
                      solve_batch=None):
    """The decomposed solve behind ``solve_distributed``,
    ``solve_distributed_steppable`` and ``solve_distributed_sharded``: the
    same five steps, with the batched solve's deadline ``(t_kill, t0)`` when
    there is one.  ``solve_batch(sub_cost, x0_s, U_s, mids_s, enabled)``,
    when given, takes step 3's place (the sharded solve's chunks)."""
    with span("dpilqr.distributed.solve"):
        X = torch.as_tensor(X, device=resolve_device(device, X))
        if X.ndim == 2:
            X = X[None]
        dtype, dev = X.dtype, X.device
        U = torch.as_tensor(U, dtype=dtype, device=dev)
        n = fleet.n_agents
        if tuple(X.shape[1:]) != (n, fleet.nx_p):
            raise ValueError(f"X must be (T, {n}, {fleet.nx_p}), got {tuple(X.shape)}")
        if tuple(U.shape[1:]) != (n, fleet.nu_p):
            raise ValueError(f"U must be (N, {n}, {fleet.nu_p}), got {tuple(U.shape)}")
        if ignore_mask is None:
            ignore_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        ignore_mask = torch.as_tensor(ignore_mask, dtype=torch.bool, device=dev)
        radius = torch.as_tensor(radius, dtype=dtype, device=dev)
        cost = cast_cost(GameCost(*(a.to(dev) for a in cost)), dtype)

        # 1. Interaction graph from the previous trajectory (distributed.py:42).
        with span("dpilqr.distributed.graph"):
            membership = interaction_graph(X, radius, n_pos=cost.n_pos, n_d=graph_n_d)
        if K is None:
            with span("dpilqr.distributed.read"):
                K = _width_from_kmax(int(membership.sum(dim=1).max()), n)

        # 2. Gather the batch (split_graph / problem.split equivalents).
        with span("dpilqr.distributed.gather"):
            batch = gather_subproblems(membership, K)
            sub_cost = gather_cost(cost, batch, dtype)
            x0_s = gather_states(X[0], batch)
            U_s = gather_controls(U, batch)
            branch = torch.as_tensor(fleet.branch_index_array, dtype=torch.int32, device=dev)
            mids_s = branch[batch.member_idx]

        # 3. One batched solve for all subproblems.
        if solve_batch is None:
            res = solve_subproblems_batched(
                fleet, config, sub_cost, x0_s, U_s, mids_s, ~ignore_mask,
                t_kill=t_kill, t0=t0, verbose=verbose,
            )
        else:
            res = solve_batch(sub_cost, x0_s, U_s, mids_s, ~ignore_mask)

        # 4. Owner extraction + scatter (ignored agents stay zero, matching the
        #    reference's skip-and-leave-zeros, distributed.py:59-63).
        with span("dpilqr.distributed.stitch"):
            X_dec, U_dec = extract_owner(batch, res.X, res.U)
            keep = (~ignore_mask).to(dtype)
            X_dec = X_dec * keep[None, :, None]
            U_dec = U_dec * keep[None, :, None]

        # 5. Joint cost of the stitched plan (distributed.py:99-103): the
        #    rollout kernel on the card, the time-batched plain version on the CPU.
        with span("dpilqr.distributed.rollout"):
            _, J_full = rollout(fleet, cost, X[0], U_dec, time_batched_cost=True)

        return DistributedResult(
            X=X_dec, U=U_dec, J=J_full, membership=membership, iters=res.iters,
            converged=res.converged, sizes=batch.sizes,
            truncated=torch.any(batch.sizes > K),
        )
