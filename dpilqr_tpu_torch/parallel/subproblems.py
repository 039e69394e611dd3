"""Subproblem batching: a membership matrix becomes one rectangular batch.

Counterpart of ``dpilqr_tpu/parallel/subproblems.py``.  Each agent's
neighborhood becomes one row of a fixed-width gather: slot 0 of subproblem
``i`` holds the owner agent ``i`` (so truncation never drops it), the other
slots hold the remaining members in ascending agent order (reference
distributed.py:246), and padded slots are masked out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.costs import GameCost


class SubproblemBatch(NamedTuple):
    member_idx: torch.Tensor  # (n, K) int64: parent agent index per slot
    member_mask: torch.Tensor  # (n, K) float32: 1.0 = real member
    owner_slot: torch.Tensor  # (n,) int64: owner agent's slot in its row
    sizes: torch.Tensor  # (n,) int32: true neighborhood sizes


def gather_subproblems(membership, K: int | None = None) -> SubproblemBatch:
    """Gather plan from an ``(n, n)`` membership matrix.

    ``K`` is the slot count (default n: no truncation, like the reference).
    If a neighborhood exceeds ``K`` its highest-index non-owner members are
    dropped; the owner always occupies slot 0.
    """
    n = membership.shape[0]
    K = n if K is None else K
    dev = membership.device
    arange = torch.arange(n, device=dev)
    is_owner = torch.eye(n, dtype=torch.bool, device=dev)
    # Sort key: owner first, then members ascending, then the rest.
    key = torch.where(membership, arange[None, :], n + arange[None, :])
    key = torch.where(is_owner, torch.full_like(key, -1), key)
    order = torch.argsort(key, dim=1, stable=True)[:, :K]
    member_mask = torch.gather(membership, 1, order)
    sizes = membership.sum(dim=1).to(torch.int32)
    # Padded slots gather the owner itself (harmless; masked out).
    member_idx = torch.where(member_mask, order, arange[:, None])
    return SubproblemBatch(
        member_idx=member_idx,
        member_mask=member_mask.to(torch.float32),
        owner_slot=torch.zeros((n,), dtype=torch.long, device=dev),
        sizes=sizes,
    )


def gather_cost(cost: GameCost, batch: SubproblemBatch, dtype) -> GameCost:
    """Per-agent cost arrays -> the batched slot layout (reference
    ``GameCost.split``, cost.py:241-262); scalar fields become ``(n_sub,)``."""
    gi = batch.member_idx
    n_sub = gi.shape[0]

    def per_sub(a):
        return a.expand(n_sub).contiguous()

    return GameCost(
        xf=cost.xf[gi],
        Q=cost.Q[gi],
        R=cost.R[gi],
        Qf=cost.Qf[gi],
        radius=per_sub(cost.radius),
        n_pos=cost.n_pos[gi],
        agent_mask=batch.member_mask.to(dtype) * cost.agent_mask[gi],
        prox_weight=per_sub(cost.prox_weight),
        ref_weight=per_sub(cost.ref_weight),
        n_pos_eval=cost.n_pos_eval[gi],
    )


def gather_states(x, batch: SubproblemBatch):
    """``x: (n, d)`` -> per-subproblem slots ``(n_sub, K, d)``."""
    return x[batch.member_idx]


def gather_controls(U, batch: SubproblemBatch):
    """``U: (N, n, d)`` -> ``(n_sub, N, K, d)`` with padded slots zeroed."""
    Us = U[:, batch.member_idx].transpose(0, 1)
    return (Us * batch.member_mask[:, None, :, None].to(U.dtype)).contiguous()


def extract_owner(batch: SubproblemBatch, X_sub, U_sub):
    """Each owner's rows of its subproblem solution (reference
    problem.py:49-64): ``X_sub (n_sub, N+1, K, nx)`` -> ``(N+1, n, nx)``,
    ``U_sub (n_sub, N, K, nu)`` -> ``(N, n, nu)``."""
    n = X_sub.shape[0]
    idx = torch.arange(n, device=X_sub.device)
    X_own = X_sub[idx, :, batch.owner_slot]
    U_own = U_sub[idx, :, batch.owner_slot]
    return X_own.transpose(0, 1), U_own.transpose(0, 1)
