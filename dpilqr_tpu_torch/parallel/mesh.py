"""The subproblem batch split over the visible cards: one decomposed solve,
or Monte-Carlo trials as one kernel batch.

Counterpart of ``dpilqr_tpu/parallel/mesh.py`` (``make_mesh``,
``solve_distributed_sharded``, ``solve_trials_sharded``).  A mesh is a list
of devices; a batch of subproblems splits into one contiguous chunk per
device (``_solve_chunks``), each solved by ``solve_subproblems_batched`` on
its device, one chunk after the other; one card takes the whole batch in
one solve.  Subproblems are independent lanes, so the split changes no
result.

- ``solve_distributed_sharded``: ``solve_distributed`` with its batch of n
  subproblems split so; the graph, the gather, the stitch and the joint
  cost run on the mesh's first device.
- ``solve_trials_sharded``: the reference runs trials as a host loop
  (cluster/sim.sbatch); here T independent trials of the decomposed solve
  flatten their (trial, subproblem) lanes into ONE batch: a trial axis is
  just more independent subproblems, which is what the batched kernels (K1
  or K3, and K2) want.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG, SolverConfig, default_device
from ..models.fleet import Fleet
from ..ops.batched import solve_subproblems_batched
from ..ops.costs import GameCost, cast_cost
from ..ops.ilqr import SolveResult, rollout
from ..utils.profiling import span
from .distributed import DistributedResult, _solve_decomposed
from .graph import interaction_graph
from .subproblems import (
    extract_owner,
    gather_controls,
    gather_cost,
    gather_states,
    gather_subproblems,
)


def make_mesh(devices=None) -> list[torch.device]:
    """The devices a trial batch splits over: every visible card, or the
    given ones (``["cpu", "cpu"]`` splits on the CPU).  Raises without a
    card when none are given."""
    if devices is None:
        default_device()  # raises where torch finds no card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def stack_costs(costs) -> GameCost:
    """T per-trial ``GameCost``s of one fleet as one with a leading trial
    axis on every field."""
    return GameCost(*(torch.stack(fields) for fields in zip(*costs)))


def _chunks(S: int, d: int) -> list[slice]:
    """``S`` lanes in ``d`` contiguous chunks of ``ceil(S / d)`` (the last
    one shorter; none empty)."""
    per = -(-S // d)
    return [slice(i, min(i + per, S)) for i in range(0, S, per)]


def _solve_chunks(fleet: Fleet, config: SolverConfig, mesh, home, sub_cost: GameCost,
                  x0_s, U_s, mids_s, enabled) -> SolveResult:
    """A flat batch of subproblems in one contiguous chunk per device of
    ``mesh`` (``_chunks``), each solved by ``solve_subproblems_batched`` on
    its device, one after the other; the results concatenated on ``home``."""
    results = []
    with span("dpilqr.mesh.chunks"):
        for dev, sl in zip(mesh, _chunks(x0_s.shape[0], len(mesh))):
            res = solve_subproblems_batched(
                fleet, config, GameCost(*(a[sl].to(dev) for a in sub_cost)),
                x0_s[sl].to(dev), U_s[sl].to(dev), mids_s[sl].to(dev),
                enabled[sl].to(dev))
            results.append([a.to(home) for a in res])
        return SolveResult(*(torch.cat(f) for f in zip(*results)))


def solve_distributed_sharded(
    fleet: Fleet,
    cost: GameCost,
    X,
    U,
    radius,
    mesh,
    ignore_mask=None,
    K: int | None = None,
    graph_n_d: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
) -> DistributedResult:
    """``solve_distributed`` with its subproblem batch split over ``mesh``
    (a ``make_mesh`` list): the interaction graph and the gather on
    ``mesh[0]``, the batch in one contiguous chunk per device, the owners'
    rows stitched, the ignored agents zeroed and the joint cost rolled out
    on ``mesh[0]``.  Arguments and result as ``solve_distributed``'s
    (``K=None``: the maximum neighbourhood size rounded up to a power of
    two, as ``auto_subproblem_width``); the result equals its, bit for
    bit."""
    home = mesh[0]
    return _solve_decomposed(
        fleet, cost, torch.as_tensor(X, device=home), U, radius, ignore_mask, K,
        graph_n_d, config, home,
        solve_batch=lambda *batch: _solve_chunks(fleet, config, mesh, home, *batch))


def solve_trials_sharded(
    fleet: Fleet,
    cost_T: GameCost,
    X_T,
    U_T,
    radius,
    mesh,
    K: int,
    ignore_mask=None,
    graph_n_d: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
) -> DistributedResult:
    """T independent decomposed solves as one batch of T * n subproblems.

    ``cost_T``: a ``GameCost`` with a leading trial axis on every field
    (``stack_costs``); ``X_T (T, Tw, n, nx_p)`` the previous trajectories
    (their first rows are the initial states); ``U_T (T, N, n, nu_p)`` the
    warm starts; ``K`` the slot count of every trial; ``mesh`` a
    ``make_mesh`` list.  Each trial's graph and gather are built on the
    mesh's first device (a host loop over T), the flat batch is solved in
    one contiguous chunk per device, and each trial's owner rows are
    stitched and its plan rolled out as ``solve_distributed`` does, so a
    trial's result is that of its own ``solve_distributed`` at the same K.
    Returns a ``DistributedResult`` with a leading trial axis.
    """
    with span("dpilqr.mesh.trials"):
        home = mesh[0]
        X_T = torch.as_tensor(X_T, device=home)
        dtype = X_T.dtype
        U_T = torch.as_tensor(U_T, dtype=dtype, device=home)
        T, n = X_T.shape[0], fleet.n_agents
        if X_T.ndim != 4 or tuple(X_T.shape[2:]) != (n, fleet.nx_p):
            raise ValueError(f"X_T must be (T, Tw, {n}, {fleet.nx_p}), got {tuple(X_T.shape)}")
        if U_T.ndim != 4 or tuple(U_T.shape[::2]) != (T, n) or U_T.shape[3] != fleet.nu_p:
            raise ValueError(
                f"U_T must be ({T}, N, {n}, {fleet.nu_p}), got {tuple(U_T.shape)}")
        if ignore_mask is None:
            ignore_mask = torch.zeros((n,), dtype=torch.bool, device=home)
        ignore_mask = torch.as_tensor(ignore_mask, dtype=torch.bool, device=home)
        radius = torch.as_tensor(radius, dtype=dtype, device=home)
        branch = torch.as_tensor(fleet.branch_index_array, dtype=torch.int32, device=home)

        # 1. Each trial's graph and gathered subproblems.
        costs, batches, parts = [], [], []
        with span("dpilqr.mesh.gather"):
            for t in range(T):
                cost = cast_cost(GameCost(*(a[t].to(home) for a in cost_T)), dtype)
                with span("dpilqr.mesh.graph"):
                    membership = interaction_graph(X_T[t], radius, n_pos=cost.n_pos,
                                                   n_d=graph_n_d)
                batch = gather_subproblems(membership, K)
                costs.append(cost)
                batches.append((membership, batch))
                parts.append((gather_cost(cost, batch, dtype),
                              gather_states(X_T[t, 0], batch),
                              gather_controls(U_T[t], batch), branch[batch.member_idx]))

        # 2. (trial, subproblem) lanes flattened into one batch, a chunk a device.
        with span("dpilqr.mesh.flatten"):
            sub_cost = GameCost(*(torch.cat(f) for f in zip(*(p[0] for p in parts))))
            x0_s, U_s, mids_s = (torch.cat([p[i] for p in parts]) for i in (1, 2, 3))
            enabled = (~ignore_mask).repeat(T)
        X_s, U_sol, _, iters, converged, _ = _solve_chunks(
            fleet, config, mesh, home, sub_cost, x0_s, U_s, mids_s, enabled)

        # 3. Per trial: owner rows, ignored agents zeroed, the stitched plan's
        #    cost.
        keep = (~ignore_mask).to(dtype)
        out = []
        with span("dpilqr.mesh.stitch"):
            for t, (cost, (membership, batch)) in enumerate(zip(costs, batches)):
                lanes = slice(t * n, (t + 1) * n)
                X_dec, U_dec = extract_owner(batch, X_s[lanes], U_sol[lanes])
                X_dec = X_dec * keep[None, :, None]
                U_dec = U_dec * keep[None, :, None]
                with span("dpilqr.mesh.rollout"):
                    _, J = rollout(fleet, cost, X_T[t, 0], U_dec, time_batched_cost=True)
                out.append(DistributedResult(
                    X=X_dec, U=U_dec, J=J, membership=membership, iters=iters[lanes],
                    converged=converged[lanes], sizes=batch.sizes,
                    truncated=torch.any(batch.sizes > K)))
            return DistributedResult(*(torch.stack(f) for f in zip(*out)))
