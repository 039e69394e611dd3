"""Potential-game cost: per-agent quadratic tracking + pairwise proximity.

Counterpart of ``dpilqr_tpu/ops/costs.py`` (reference dpilqr/cost.py):

- reference cost ``(x-xf)^T Q (x-xf) + u^T R u`` with gradients through
  ``Q+Q^T`` / ``R+R^T`` (cost.py:79-101);
- proximity ``sum_pairs min(0, d_ij - radius)^2`` with per-pair position
  size ``min(n_pos_i, n_pos_j)`` (cost.py:117-171);
- game cost ``ref_weight * sum_i ref_i + prox_weight * prox``, proximity
  applying at the terminal state too (cost.py:185-239).

``make_game_cost(..., prox_eval_n_d=2)`` reproduces the reference's quirk of
evaluating proximity in 2-D while differentiating with ``n_pos``.

Batching: every function takes ``x (*B, n, nx_p)`` (``u`` alike) and a
``GameCost`` whose per-agent fields are ``(*B', n, ...)`` and whose scalar
fields are ``(*B')``, with ``B'`` broadcasting against ``B``.  The JAX
package's single-problem case is ``B = ()``; a batch of gathered
subproblems over a horizon is ``B = (S, N)`` with ``B' = (S, 1)``.
Padded slots (``agent_mask`` 0) contribute no cost and get an identity
control Hessian, keeping the Riccati recursion exactly decoupled.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..config import resolve_device

_EPS = 1e-12


class GameCost(NamedTuple):
    """Tensor-valued cost specification."""

    xf: torch.Tensor  # (n, nx_p) goal states (padded)
    Q: torch.Tensor  # (n, nx_p, nx_p) stage state weights
    R: torch.Tensor  # (n, nu_p, nu_p) stage control weights
    Qf: torch.Tensor  # (n, nx_p, nx_p) terminal state weights
    radius: torch.Tensor  # () proximity radius
    n_pos: torch.Tensor  # (n,) int32: 2 or 3 position coords (derivatives)
    agent_mask: torch.Tensor  # (n,) 1.0 = real agent, 0.0 = padded slot
    prox_weight: torch.Tensor  # () default 200.0
    ref_weight: torch.Tensor  # () default 1.0
    n_pos_eval: torch.Tensor  # (n,) int32 position coords for EVALUATION


_INT_FIELDS = ("n_pos", "n_pos_eval")


def make_game_cost(
    xf,
    Q,
    R,
    Qf,
    radius=0.0,
    n_pos=None,
    agent_mask=None,
    prox_weight=200.0,
    ref_weight=1.0,
    dtype=None,
    device=None,
    prox_eval_n_d=None,
) -> GameCost:
    """Build a GameCost from per-agent arrays.

    ``xf: (n, nx_p)``; ``Q/Qf: (n, nx_p, nx_p)``; ``R: (n, nu_p, nu_p)``.
    ``prox_eval_n_d``: if set (e.g. 2), the proximity *penalty* is evaluated
    with that many position dimensions while its derivatives keep ``n_pos``
    (the reference's behavior for uniform-dimension fleets).  A tensor
    ``xf`` keeps its device; numpy input goes to ``device`` (default: the
    card, ``config.default_device``).
    """
    xf = torch.as_tensor(xf, dtype=dtype, device=resolve_device(device, xf))
    n = xf.shape[0]
    dtype, device = xf.dtype, xf.device
    if n_pos is None:
        n_pos = np.full((n,), 2, dtype=np.int32)
    if agent_mask is None:
        agent_mask = np.ones((n,))
    n_pos = torch.as_tensor(n_pos, dtype=torch.int32, device=device)
    if prox_eval_n_d is None:
        n_pos_eval = n_pos
    else:
        n_pos_eval = torch.full(
            (n,), int(prox_eval_n_d), dtype=torch.int32, device=device
        )

    def fl(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return GameCost(
        xf=xf, Q=fl(Q), R=fl(R), Qf=fl(Qf), radius=fl(radius), n_pos=n_pos,
        agent_mask=fl(agent_mask), prox_weight=fl(prox_weight),
        ref_weight=fl(ref_weight), n_pos_eval=n_pos_eval,
    )


def game_cost_from_numpy(
    fields: Mapping[str, np.ndarray], device=None, dtype=None
) -> GameCost:
    """GameCost from its 10 fields by name (e.g. another package's cost
    converted with ``np.asarray``); floating fields take ``dtype`` (default:
    their own), the position-size fields stay int32.  The cost lands on
    ``device`` (default: the card, ``config.default_device``)."""
    missing = set(GameCost._fields) - set(fields)
    if missing:
        raise ValueError(f"missing GameCost fields: {sorted(missing)}")
    device = resolve_device(device)
    return GameCost(
        **{
            k: torch.as_tensor(
                np.array(fields[k]),
                dtype=torch.int32 if k in _INT_FIELDS else dtype,
                device=device,
            )
            for k in GameCost._fields
        }
    )


def cast_cost(cost: GameCost, dtype) -> GameCost:
    """Cast the floating fields to ``dtype`` (integer fields unchanged)."""
    return GameCost(
        *(a if k in _INT_FIELDS else a.to(dtype)
          for k, a in zip(GameCost._fields, cost))
    )


@lru_cache(maxsize=64)
def _pairs(n: int, device: torch.device):
    ii, jj = np.triu_indices(n, k=1)
    return (torch.as_tensor(ii, device=device),
            torch.as_tensor(jj, device=device))


@lru_cache(maxsize=64)
def _partners(n: int, device: torch.device):
    """Each agent's pairs in partner order: ``idx (n, n-1)``, agent i's
    pairs p = (i, j) for j = 0..n-1, j != i, as indices into ``_pairs``;
    ``sign (n, n-1)``, +1 where i is the pair's first agent (its gradient
    term is the pair's) and -1 where it is the second; ``p_of (n, n)``, the
    pair of (i, j) (0 on the diagonal)."""
    ii, jj = np.triu_indices(n, k=1)
    p_of = np.zeros((n, n), dtype=np.int64)
    p_of[ii, jj] = p_of[jj, ii] = np.arange(len(ii))
    j = np.array([[j for j in range(n) if j != i] for i in range(n)],
                 dtype=np.int64).reshape(n, n - 1)
    idx = np.take_along_axis(p_of, j, axis=1)
    sign = np.where(j > np.arange(n)[:, None], 1.0, -1.0)
    return (torch.as_tensor(idx, device=device), torch.as_tensor(sign, device=device),
            torch.as_tensor(p_of, device=device))


def _ordered_sum(t, dim: int):
    """Sum over ``dim`` in index order by elementwise adds.  A batched
    matrix product or a reduction may group its sums by the batch's size (a
    kernel chosen per shape, on the card), so a subproblem's result would
    depend on the batch it was computed in; this one does not."""
    acc = t.select(dim, 0)
    for r in range(1, t.shape[dim]):
        acc = acc + t.select(dim, r)
    return acc


def _pair_geometry(cost: GameCost, x, n_pos_src=None):
    """Per-pair ``(delta (*B, P, 3), d (*B, P), w_pair (*B, P), comp)``.

    ``delta`` is the component-masked position difference, ``w_pair`` the
    pair activity weight ``mask_i * mask_j * [d < r]``; ``n_pos_src``
    selects the position sizes (default ``cost.n_pos``; evaluation passes
    ``cost.n_pos_eval``)."""
    n, nx_p = x.shape[-2:]
    k = min(3, nx_p)
    ii, jj = _pairs(n, x.device)
    pos = torch.nn.functional.pad(x[..., :k], (0, 3 - k))
    delta_raw = pos[..., ii, :] - pos[..., jj, :]
    npos = cost.n_pos if n_pos_src is None else n_pos_src
    nd_pair = torch.minimum(npos[..., ii], npos[..., jj])
    comp = torch.arange(3, device=x.device) < nd_pair[..., None]
    delta = delta_raw * comp.to(x.dtype)
    d = torch.sqrt(torch.sum(delta * delta, dim=-1))
    active = (d < cost.radius[..., None]).to(x.dtype)
    m = cost.agent_mask
    w_pair = m[..., ii] * m[..., jj] * active
    return delta, d, w_pair, comp


def proximity_cost(cost: GameCost, x):
    """Unweighted ``sum_pairs min(0, d - r)^2`` (reference cost.py:117-133)."""
    if x.shape[-2] < 2:
        return torch.zeros(x.shape[:-2], dtype=x.dtype, device=x.device)
    _, d, w_pair, _ = _pair_geometry(cost, x, cost.n_pos_eval)
    pen = torch.clamp(d - cost.radius[..., None], max=0.0) ** 2
    return torch.sum(w_pair * pen, dim=-1)


def proximity_quadraticize_compact(cost: GameCost, x):
    """Exact proximity gradient ``L_x (*B, n, nx_p)`` (scattered into agent
    blocks) and compact pair Hessians ``H (*B, npairs, k, k)``,
    ``k = min(3, nx_p)``."""
    n, nx_p = x.shape[-2:]
    k = min(3, nx_p)
    delta, d, w_pair, comp = _pair_geometry(cost, x)
    r = cost.radius[..., None]
    d_safe = torch.clamp(d, min=_EPS)

    # grad wrt pos_i: 2 (d - r)/d * delta
    g = (w_pair * 2.0 * (d - r) / d_safe)[..., None] * delta

    # Hessian: (2 - 2r/d) I + (2r/d^3) delta delta^T, masked to active comps.
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    H = (2.0 - 2.0 * r / d_safe)[..., None, None] * eye3 + (
        2.0 * r / d_safe**3
    )[..., None, None] * (delta[..., :, None] * delta[..., None, :])
    cm = comp.to(x.dtype)
    H = H * (cm[..., :, None] * cm[..., None, :]) * w_pair[..., None, None]

    # Agent i's gradient: its pairs' terms in partner order (as K5 sums them).
    idx, sign, _ = _partners(n, x.device)
    L_x = _ordered_sum(g[..., idx, :k] * sign.to(x.dtype)[..., None], dim=-2)
    L_x = torch.nn.functional.pad(L_x, (0, nx_p - k))
    return L_x, H[..., :k, :k]


def assemble_pair_hessian(H, n: int, nx_p: int):
    """Compact pair Hessians ``(*B, npairs, k, k)`` -> full block coupling
    ``(*B, n, nx_p, n, nx_p)``: per pair p=(i,j) the block lands at
    ``(+ii, +jj, -ij, -ji)`` (reference cost.py:160-166)."""
    k = H.shape[-1]
    idx, _, p_of = _partners(n, H.device)
    # Block (i, j) of pair p: -H_p; block (i, i): agent i's pairs' H_p
    # summed in partner order.
    diag = _ordered_sum(H[..., idx, :, :], dim=-3)  # (*B, n, k, k)
    eye = torch.eye(n, dtype=torch.bool, device=H.device)[..., None, None]
    blocks = torch.where(eye, diag[..., :, None, :, :], -H[..., p_of, :, :])
    L_xx = H.new_zeros((*H.shape[:-3], n, nx_p, n, nx_p))
    L_xx[..., :k, :, :k] = blocks.transpose(-3, -2)
    return L_xx


def proximity_quadraticize(cost: GameCost, x):
    """Exact gradient ``(*B, n, nx_p)`` and Hessian ``(*B, n, nx_p, n, nx_p)``
    of the proximity penalty (reference closed form, cost.py:269-315)."""
    n, nx_p = x.shape[-2:]
    if n < 2:
        return (
            torch.zeros_like(x),
            x.new_zeros((*x.shape[:-2], n, nx_p, n, nx_p)),
        )
    L_x, H = proximity_quadraticize_compact(cost, x)
    return L_x, assemble_pair_hessian(H, n, nx_p)


def _quadform(M, v):
    """``v^T M v`` over the last two dims of ``M``: -> ``v.shape[:-1]``."""
    return torch.sum(v * (M @ v[..., None])[..., 0], dim=-1)


def stage_cost(cost: GameCost, x, u):
    """Weighted game stage cost (reference cost.py:197-206) -> ``(*B)``."""
    e = x - cost.xf
    ref = _quadform(cost.Q, e) + _quadform(cost.R, u)
    m = cost.agent_mask
    total = cost.ref_weight * torch.sum(m * ref, dim=-1)
    total = total + cost.prox_weight * proximity_cost(cost, x)
    # Padded slots: control regularizer matching the quadraticization
    # (contributes 0 while the slot's controls stay 0).
    return total + torch.sum((1.0 - m) * torch.sum(u * u, dim=-1), dim=-1)


def terminal_cost(cost: GameCost, x):
    """Weighted terminal cost; proximity applies here too (cost.py:197-206)."""
    e = x - cost.xf
    ref = _quadform(cost.Qf, e)
    total = cost.ref_weight * torch.sum(cost.agent_mask * ref, dim=-1)
    return total + cost.prox_weight * proximity_cost(cost, x)


def _vecmat(e, M):
    """``e^T M`` over the last dims: ``(..., a), (..., a, b) -> (..., b)``,
    summed in index order (``_ordered_sum``)."""
    return _ordered_sum(e[..., :, None] * M, dim=-2)


def quadraticize_stage_compact(cost: GameCost, x, u):
    """Stage quadraticization in compact block form.

    Returns ``(L_x (*B, n, nx_p), L_u (*B, n, nu_p), L_xx_diag
    (*B, n, nx_p, nx_p), L_uu (*B, n, nu_p, nu_p), H_pair (*B, P, k, k))``
    with all weights applied; the full state Hessian is
    ``diag_embed(L_xx_diag) + assemble_pair_hessian(H_pair)``.
    """
    n, nx_p = x.shape[-2:]
    nu_p = u.shape[-1]
    m = cost.agent_mask
    e = x - cost.xf
    QQt = cost.Q + cost.Q.transpose(-1, -2)
    RRt = cost.R + cost.R.transpose(-1, -2)
    w = cost.ref_weight[..., None] * m  # ref_weight * mask, (*B', n)

    L_x = w[..., None] * _vecmat(e, QQt)
    L_u = w[..., None] * _vecmat(u, RRt)
    L_xx_diag = w[..., None, None] * QQt
    L_uu = w[..., None, None] * RRt

    # Padded-slot control regularizer: d/du of (1-m) u^T u.
    eye_u = torch.eye(nu_p, dtype=x.dtype, device=x.device)
    L_u = L_u + 2.0 * (1.0 - m)[..., None] * u
    L_uu = L_uu + 2.0 * (1.0 - m)[..., None, None] * eye_u

    k = min(3, nx_p)
    if n > 1:
        Lp_x, H = proximity_quadraticize_compact(cost, x)
        pw = cost.prox_weight
        L_x = L_x + pw[..., None, None] * Lp_x
        H = pw[..., None, None, None] * H
    else:
        H = x.new_zeros((*x.shape[:-2], 0, k, k))
    return L_x, L_u, L_xx_diag, L_uu, H


def quadraticize_terminal_compact(cost: GameCost, x):
    """Terminal analog of ``quadraticize_stage_compact``:
    ``(L_x, L_xx_diag, H_pair)`` using Qf, proximity included."""
    n, nx_p = x.shape[-2:]
    m = cost.agent_mask
    e = x - cost.xf
    QfQft = cost.Qf + cost.Qf.transpose(-1, -2)
    w = cost.ref_weight[..., None] * m
    L_x = w[..., None] * _vecmat(e, QfQft)
    L_xx_diag = w[..., None, None] * QfQft
    k = min(3, nx_p)
    if n > 1:
        Lp_x, H = proximity_quadraticize_compact(cost, x)
        pw = cost.prox_weight
        L_x = L_x + pw[..., None, None] * Lp_x
        H = pw[..., None, None, None] * H
    else:
        H = x.new_zeros((*x.shape[:-2], 0, k, k))
    return L_x, L_xx_diag, H


def diag_embed(blocks):
    """``(*B, n, a, b)`` block-diagonal embed -> ``(*B, n, a, n, b)``."""
    n = blocks.shape[-3]
    eye_n = torch.eye(n, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("ij,...iab->...iajb", eye_n, blocks)


def quadraticize_stage(cost: GameCost, x, u):
    """Stage quadraticization in block layout (reference cost.py:208-239):
    ``L_x``, ``L_u``, ``L_xx (*B, n, nx_p, n, nx_p)``, ``L_uu`` (block
    diagonal; ``L_ux`` is identically zero for this cost family)."""
    n, nx_p = x.shape[-2:]
    L_x, L_u, L_xx_diag, L_uu, H = quadraticize_stage_compact(cost, x, u)
    L_xx = diag_embed(L_xx_diag)
    if n > 1:
        L_xx = L_xx + assemble_pair_hessian(H, n, nx_p)
    return L_x, L_u, L_xx, L_uu


def quadraticize_terminal(cost: GameCost, x):
    """Terminal quadraticization: uses Qf; proximity included."""
    n, nx_p = x.shape[-2:]
    L_x, L_xx_diag, H = quadraticize_terminal_compact(cost, x)
    L_xx = diag_embed(L_xx_diag)
    if n > 1:
        L_xx = L_xx + assemble_pair_hessian(H, n, nx_p)
    return L_x, L_xx
