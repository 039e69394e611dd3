"""Associative-scan (parallel) Riccati backward pass, in plain PyTorch.

Counterpart of ``dpilqr_tpu/ops/pscan.py``.  The sequential Riccati sweep
(``ops.ilqr._backward_pass``, reference control.py:116-148) has an O(N)
dependency chain.  Following the parallel-LQT construction of Sarkka &
Garcia-Fernandez ("Temporal Parallelization of Bayesian Smoothers", IEEE
TAC 2021), the value recursion decomposes into elements ``e = (A, b, C,
eta, J)`` representing the optimally controlled flow and cost-to-go of a
time INTERVAL, with an associative combine, so the whole sweep runs in
O(log N) depth.  PyTorch has no stable associative scan, so ``_assoc_scan``
is written out here: the recursive odd-even scheme (combine neighbouring
pairs, scan the half-length sequence, fill in the even positions), about 2N
combines in 2 log2 N batched calls.

Handling the reference's Tassa-style regularization: the mu-regularized
recursion (``B^T (P + mu I) B`` sandwiches, control.py:137-140) equals the
UNREGULARIZED recursion of a modified stage cost with
``L_uu' = L_uu + mu B^T B`` and cross term ``L_ux' = mu B^T A``; the cross
term is then removed by the standard change of variables
``u = v - L_uu'^{-1} L_ux' x`` giving ``A~ = A - B L_uu'^{-1} L_ux'``,
``L~xx = L_xx - L_ux'^T L_uu'^{-1} L_ux'``, an exact reduction
(``tests/test_torch_pscan.py`` holds it element for element against the
sequential sweep).

Enabled with ``sweep_backend="pscan"`` (the centralized solve), and by
``"auto"`` on the card for a problem past K5's widest tier.  The scan is
not a hand-written kernel: its combines are batched ``torch.matmul`` calls
and the batched Gauss-Jordan of ``ops.ilqr.gauss_jordan_solve``, as the JAX
package leaves them to XLA.  The line-search rollout stays sequential
(nonlinear dynamics do not scan associatively).  Its grouping of the
combines need not equal ``jax.lax.associative_scan``'s, so the two agree to
rounding, not bitwise.
"""

from __future__ import annotations

import torch

from .costs import (
    GameCost,
    assemble_pair_hessian,
    diag_embed,
    quadraticize_stage_compact,
    quadraticize_terminal,
)
from .ilqr import gauss_jordan_solve


def _mv(M, v):
    """Batched matrix-vector product ``M v``."""
    return (M @ v[..., None])[..., 0]


def _combine(e1, e2):
    """Associative combine of value elements: e1 covers [i, k), e2 [k, j).

    ``A (.., nxf, nxf)``: closed-loop transition of the interval;
    ``b (.., nxf)``: affine drift; ``C (.., nxf, nxf)``: control-induced
    "covariance" (B Luu^-1 B^T accumulated); ``eta (.., nxf)``, ``J (..,
    nxf, nxf)``: linear/quadratic cost-to-go parameters.

    One Gauss-Jordan pass instead of the textbook two inverses: with
    ``M2 = (I + J2 C1)^{-1}`` the other factor satisfies
    ``M1 = (I + C1 J2)^{-1} = I - C1 M2 J2`` (push-through identity), so
    solving the SINGLE system ``(I + J2 C1) [T | m] = [J2 | eta2 - J2 b1]``
    yields everything: every M1-product becomes ``X - C1 (T X)`` and every
    M2-product reads off ``T`` / ``m`` directly.
    """
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2

    rhs = torch.cat([J2, (eta2 - _mv(J2, b1))[..., None]], dim=-1)
    eye = torch.eye(J2.shape[-1], dtype=J2.dtype, device=J2.device)
    Tm = gauss_jordan_solve(eye + J2 @ C1, rhs)
    T = Tm[..., :-1]  # M2 J2
    m = Tm[..., -1]  # M2 (eta2 - J2 b1)

    TA1 = T @ A1
    M1A1 = A1 - C1 @ TA1  # M1 A1
    A = A2 @ M1A1
    J = A1.transpose(-1, -2) @ TA1 + J1
    eta = _mv(A1.transpose(-1, -2), m) + eta1

    v = b1 + _mv(C1, eta2)
    M1v = v - _mv(C1, _mv(T, v))
    b = _mv(A2, M1v) + b2

    TC1 = T @ C1
    M1C1 = C1 - C1 @ TC1
    C = A2 @ M1C1 @ A2.transpose(-1, -2) + C2
    return (A, b, C, eta, J)


def _assoc_scan(fn, elems):
    """Inclusive scan of ``elems`` (a tuple of tensors with a common leading
    axis) under the associative ``fn(earlier, later)``, in O(log n) batched
    calls of ``fn``: out[i] = elems[0] (x) ... (x) elems[i]."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    # Combine neighbouring pairs (0,1), (2,3), ...; their scan gives the odd
    # positions of the result.
    n_pairs = n // 2
    pairs = fn(tuple(e[0 : 2 * n_pairs : 2] for e in elems),
               tuple(e[1 : 2 * n_pairs : 2] for e in elems))
    odd = _assoc_scan(fn, pairs)
    # Even positions 2, 4, ...: the odd result before them (x) their element.
    n_even = (n - 1) // 2
    even = None
    if n_even:
        even = fn(tuple(o[:n_even] for o in odd),
                  tuple(e[2 : 2 * n_even + 1 : 2] for e in elems))
    out = []
    for i, (e, od) in enumerate(zip(elems, odd)):
        o = torch.empty_like(e)
        o[0] = e[0]
        o[1::2] = od
        if even is not None:
            o[2::2] = even[i]
        out.append(o)
    return tuple(out)


def _flatten_blocks(cost: GameCost, X, U, lin_fn, mu):
    """Time-batched quadraticize + linearize, flattened to dense per-step
    matrices with the mu-regularization folded in as (L_uu', L_ux')."""
    N, n, nu_p = U.shape
    nx_p = X.shape[2]
    nxf, nuf = n * nx_p, n * nu_p

    L_x, L_u, L_xx_diag, L_uu, H = quadraticize_stage_compact(cost, X[:-1], U)
    L_xx_diag = L_xx_diag.expand(N, n, nx_p, nx_p)
    L_uu = L_uu.expand(N, n, nu_p, nu_p)
    A, B = lin_fn(X[:-1], U)
    B = B * cost.agent_mask[None, :, None, None]

    A_f = diag_embed(A).reshape(N, nxf, nxf)
    B_f = diag_embed(B).reshape(N, nxf, nuf)
    L_uu_f = diag_embed(L_uu).reshape(N, nuf, nuf)
    L_xx = diag_embed(L_xx_diag)
    if n > 1:
        L_xx = L_xx + assemble_pair_hessian(H, n, nx_p)
    L_xx_f = L_xx.reshape(N, nxf, nxf)
    L_x_f = L_x.reshape(N, nxf)
    L_u_f = L_u.reshape(N, nuf)

    # mu-regularization as modified cost (see module docstring).
    Bt = B_f.transpose(-1, -2)
    L_uu_r = L_uu_f + mu * (Bt @ B_f)
    L_ux_r = mu * (Bt @ A_f)
    return A_f, B_f, L_uu_r, L_ux_r, L_xx_f, L_x_f, L_u_f


def backward_pass_pscan(lin_fn, cost: GameCost, X, U, mu):
    """Parallel-scan Riccati: same ``(K (N, nuf, nxf), d (N, nuf))`` as
    ``ops.ilqr._backward_pass``, O(log N) sequential depth; all per-step
    work is batched over time."""
    N, n, nu_p = U.shape
    nx_p = X.shape[2]
    nxf = n * nx_p

    A_f, B_f, L_uu_r, L_ux_r, L_xx_f, L_x_f, L_u_f = _flatten_blocks(
        cost, X, U, lin_fn, mu
    )

    # Cross-term elimination: u = v - Kp x with Kp = L_uu'^{-1} L_ux'.
    Bt = B_f.transpose(-1, -2)
    Kpd = gauss_jordan_solve(L_uu_r, torch.cat([L_ux_r, L_u_f[..., None]], dim=-1))
    Kp, dp = Kpd[..., :nxf], Kpd[..., nxf]
    A_t = A_f - B_f @ Kp
    Lxx_t = L_xx_f - L_ux_r.transpose(-1, -2) @ Kp
    Lx_t = L_x_f - _mv(L_ux_r.transpose(-1, -2), dp)
    C_t = B_f @ gauss_jordan_solve(L_uu_r, Bt)  # B Luu'^{-1} B^T
    b_t = -_mv(B_f, dp)
    # The constant term of the eliminated control's own cost is dropped;
    # the linear term keeps Lx_t.

    # Leaf elements, time-reversed so the scan accumulates suffixes, plus
    # the terminal leaf in front.
    L_xT, L_xxT = quadraticize_terminal(cost, X[-1])
    term = (
        X.new_zeros((1, nxf, nxf)),
        X.new_zeros((1, nxf)),
        X.new_zeros((1, nxf, nxf)),
        -L_xT.reshape(1, nxf),
        L_xxT.reshape(1, nxf, nxf),
    )
    leaves = (A_t, b_t, C_t, -Lx_t, Lxx_t)
    elems = tuple(torch.cat([t, l.flip(0)]) for t, l in zip(term, leaves))
    # After the scan, position r holds the combined element of the suffix
    # [N - r, N]: a new (earlier) interval composes BEFORE the accumulated
    # suffix, so the scan's operator is combine(new, accumulated).
    scanned = _assoc_scan(lambda acc, new: _combine(new, acc), elems)
    P_next = scanned[4].flip(0)[1:]  # (N, nxf, nxf): P_{t+1}
    p_next = -scanned[3].flip(0)[1:]  # (N, nxf)

    # Gains from (P_{t+1}, p_{t+1}) exactly like the sequential sweep.
    Q_uu = L_uu_r + Bt @ P_next @ B_f
    Q_ux = L_ux_r + Bt @ P_next @ A_f
    Q_u = L_u_f + _mv(Bt, p_next)
    sol = gauss_jordan_solve(Q_uu, torch.cat([Q_ux, Q_u[..., None]], dim=-1))
    return -sol[..., :nxf], -sol[..., nxf]
