"""The reference: dynamics, game cost, interaction graph, gather and a
batched iLQR, in plain PyTorch.

Shapes: a batch of S subproblems of K slots, states ``(S, K, nx)``, controls
``(S, K, nu)``, trajectories ``(S, N+1, K, nx)``.  A cost is a dict of
per-slot fields ``xf (S, K, nx)``, ``Q``, ``Qf (S, K, nx, nx)``, ``R (S, K,
nu, nu)``, ``n_pos``, ``n_pos_eval (S, K)`` (int), ``mask (S, K)`` and the
per-subproblem scalars ``radius``, ``prox_w``, ``ref_w (S,)``.  A whole
fleet is one subproblem of K = n slots.

Each slot carries its model: ``models`` is an array of ModelSpec names,
one a slot (a mixed fleet's slots are padded to the widest model's ``nx``,
``nu``).  A model's dynamics is a file of its
own, ``models/<name>.py``, found by the name; each model is evaluated on
its own slots' leading coordinates, and a padded coordinate never moves.
A batch of one model takes the same arithmetic as a fleet of that model
alone.

The solve follows the reference's ``ilqrSolver.solve`` (control.py:150-242)
per subproblem: the warm start rolled out, then at most ``n_lqr_iter``
iterations of a backward pass with the state regularization ``B^T (P + mu
I) B``, a line search over ``alpha = 1.1^(-i^2)`` that takes the first
alpha whose cost is lower, the relative-decrease test against ``tol``, the
decrease of ``mu`` on acceptance (snapped to 0 at ``mu_min``) and the bail
on a failed line search.  Padded slots (mask 0) carry no cost, get the
control penalty ``(1 - m) u^T u`` and ``B = 0``, so they never move.  A
subproblem that the solve leaves out (an uncontrolled agent's, the
reference's ``ignore_ids``) returns its warm start rolled out.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..harness.spec import load_module

# One file a model, ``models/<ModelSpec name>.py``: ``NX``, ``NU``,
# ``SUBSTEPS`` (RK4 substeps a control period), the continuous right-hand
# side ``f(x (..., NX), u (..., NU))`` and its Jacobians ``jac(x, u) -> (A
# (..., NX, NX), B (..., NX, NU))``, in plain PyTorch.
MODELS_DIR = Path(__file__).resolve().parent / "models"
# name -> its loaded module.
LOADED: dict = {}


# ---------------------------------------------------------------- dynamics

def dynamics(name: str):
    """The reference dynamics of the model ``name``, from ``models/<name>.py``."""
    if name not in LOADED:
        LOADED[name] = load_module(MODELS_DIR / f"{name}.py", f"perfbench_reference_{name}")
    return LOADED[name]


def _slots(models, x, u):
    """``models`` over the slots of ``x (..., nx_p)``: ``[(model, rows)]``,
    ``rows`` None where one model fills every slot at its own width, else
    a bool tensor of ``x.shape[:-1]`` selecting the model's slots."""
    names = np.asarray(models)
    uniq = list(dict.fromkeys(names.reshape(-1).tolist()))
    if len(uniq) == 1:
        m = dynamics(uniq[0])
        if (m.NX, m.NU) == (x.shape[-1], u.shape[-1]):
            return [(m, None)]
    return [(dynamics(n), torch.as_tensor(names == n, device=x.device).expand(x.shape[:-1]))
            for n in uniq]


def _rk4(m, x, u, dt: float):
    """One control period of ``m``: RK4 with ``m.SUBSTEPS`` equal substeps
    under zero-order hold."""
    dh = dt / m.SUBSTEPS
    for _ in range(m.SUBSTEPS):
        k0 = m.f(x, u)
        k1 = m.f(x + 0.5 * dh * k0, u)
        k2 = m.f(x + 0.5 * dh * k1, u)
        k3 = m.f(x + dh * k2, u)
        x = x + dh * (k0 + 2.0 * k1 + 2.0 * k2 + k3) / 6.0
    return x


def step(models, x, u, dt: float):
    """One control period of ``x (..., K, nx_p)`` under ``u (..., K, nu_p)``.
    ``models``: an array of names, one a slot, broadcasting against
    ``x.shape[:-1]``.  Each model steps its own slots'
    leading ``NX`` coordinates under their leading ``NU`` controls; a
    slot's padded coordinates keep their values."""
    slots = _slots(models, x, u)
    if slots[0][1] is None:
        return _rk4(slots[0][0], x, u, dt)
    out = x.clone()
    for m, rows in slots:
        xm, um = x[rows], u[rows]
        out[rows] = torch.cat([_rk4(m, xm[:, :m.NX], um[:, :m.NU], dt), xm[:, m.NX:]], -1)
    return out


def linearize(models, x, u, dt: float):
    """Forward-Euler discretized Jacobians ``I + dt A_c``, ``dt B_c``; a
    slot's padded coordinates have zero dynamics (an identity row of ``A``,
    a zero row of ``B``) and its padded controls zero columns of ``B``."""
    nx, nu = x.shape[-1], u.shape[-1]
    eye = torch.eye(nx, dtype=x.dtype, device=x.device)
    slots = _slots(models, x, u)
    if slots[0][1] is None:
        A, B = slots[0][0].jac(x, u)
        return eye + dt * A, dt * B
    A = x.new_zeros((*x.shape, nx))
    B = x.new_zeros((*x.shape, nu))
    for m, rows in slots:
        Am, Bm = m.jac(x[rows][:, :m.NX], u[rows][:, :m.NU])
        A[rows] = torch.nn.functional.pad(Am, (0, nx - m.NX, 0, nx - m.NX))
        B[rows] = torch.nn.functional.pad(Bm, (0, nu - m.NU, 0, nx - m.NX))
    return eye + dt * A, dt * B


def rollout(models, x0, U, dt: float):
    """``x0 (..., K, nx)``, ``U (..., N, K, nu)`` -> ``X (..., N+1, K, nx)``."""
    X = [x0]
    for t in range(U.shape[-3]):
        X.append(step(models, X[-1], U[..., t, :, :], dt))
    return torch.stack(X, dim=-3)


def lanes(models, a):
    """``models`` of the subproblems ``a`` (indices): a per-subproblem array
    of names ``(S, K)`` is cut to those rows; one name a slot ``(K,)``
    serves every subproblem."""
    if np.ndim(models) < 2:
        return models
    return np.asarray(models)[np.asarray(a.cpu())]


# ---------------------------------------------------------------- cost

def cost_to(c: dict, dtype=None, device=None) -> dict:
    """The cost's floating fields in ``dtype`` on ``device``."""
    return {k: (v.to(device=device) if k in ("n_pos", "n_pos_eval")
                else v.to(dtype=dtype, device=device)) for k, v in c.items()}


def _pairs(K: int, device):
    ii, jj = np.triu_indices(K, k=1)
    return torch.as_tensor(ii, device=device), torch.as_tensor(jj, device=device)


def _pair_geometry(c: dict, x, n_pos):
    """Per pair ``(delta (..., S, P, 3), d (..., S, P), active weight)``."""
    K, nx = x.shape[-2:]
    k = min(3, nx)
    ii, jj = _pairs(K, x.device)
    pos = torch.nn.functional.pad(x[..., :k], (0, 3 - k))
    nd = torch.minimum(n_pos[..., ii], n_pos[..., jj])
    comp = (torch.arange(3, device=x.device) < nd[..., None]).to(x.dtype)
    delta = (pos[..., ii, :] - pos[..., jj, :]) * comp
    d = torch.sqrt(torch.sum(delta * delta, dim=-1))
    m = c["mask"]
    w = m[..., ii] * m[..., jj] * (d < c["radius"][..., None]).to(x.dtype)
    return delta, d, w


def _prox(c: dict, x):
    if x.shape[-2] < 2:
        return x.new_zeros(x.shape[:-2])
    _, d, w = _pair_geometry(c, x, c["n_pos_eval"])
    return torch.sum(w * torch.clamp(d - c["radius"][..., None], max=0.0) ** 2, dim=-1)


def _quad(M, e):
    return torch.einsum("...ki,...kij,...kj->...k", e, M, e)


def stage_cost(c: dict, x, u):
    """Stage cost of ``x (..., S, K, nx)``, ``u (..., S, K, nu)`` -> ``(..., S)``."""
    m = c["mask"]
    ref = _quad(c["Q"], x - c["xf"]) + _quad(c["R"], u)
    out = c["ref_w"] * torch.sum(m * ref, dim=-1) + c["prox_w"] * _prox(c, x)
    return out + torch.sum((1.0 - m) * torch.sum(u * u, dim=-1), dim=-1)


def terminal_cost(c: dict, x):
    ref = _quad(c["Qf"], x - c["xf"])
    return c["ref_w"] * torch.sum(c["mask"] * ref, dim=-1) + c["prox_w"] * _prox(c, x)


def trajectory_cost(c: dict, X, U):
    """``X (S, N+1, K, nx)``, ``U (S, N, K, nu)`` -> ``(S,)``."""
    Xt, Ut = X.transpose(0, 1), U.transpose(0, 1)  # time first
    return torch.sum(stage_cost(c, Xt[:-1], Ut), dim=0) + terminal_cost(c, Xt[-1])


def _blockdiag(blocks):
    """``(S, K, a, b)`` -> ``(S, K a, K b)``."""
    S, K, a, b = blocks.shape
    eye = torch.eye(K, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("ij,siab->siajb", eye, blocks).reshape(S, K * a, K * b)


def quadraticize(c: dict, x, u=None):
    """Gradients and Hessians of the stage cost at ``x (S, K, nx)``, ``u (S,
    K, nu)`` (the terminal cost when ``u`` is None): ``L_x (S, nxf)``,
    ``L_xx (S, nxf, nxf)``, and for a stage ``L_u (S, nuf)``, ``L_uu``."""
    S, K, nx = x.shape
    m = c["mask"]
    w = c["ref_w"][:, None] * m
    W = c["Q"] if u is not None else c["Qf"]
    WW = W + W.transpose(-1, -2)
    L_x = w[..., None] * torch.einsum("ski,skij->skj", x - c["xf"], WW)
    L_xx = _blockdiag(w[..., None, None] * WW)
    if K > 1:
        k = min(3, nx)
        ii, jj = _pairs(K, x.device)
        delta, d, wp = _pair_geometry(c, x, c["n_pos"])
        r = c["radius"][:, None]
        ds = torch.clamp(d, min=1e-12)
        g = (wp * 2.0 * (d - r) / ds)[..., None] * delta  # (S, P, 3)
        eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
        H = ((2.0 - 2.0 * r / ds)[..., None, None] * eye3
             + (2.0 * r / ds ** 3)[..., None, None] * delta[..., :, None] * delta[..., None, :])
        nd = torch.minimum(c["n_pos"][..., ii], c["n_pos"][..., jj])
        cm = (torch.arange(3, device=x.device) < nd[..., None]).to(x.dtype)
        H = H * cm[..., :, None] * cm[..., None, :] * wp[..., None, None]
        pw = c["prox_w"][:, None, None]
        Gk = x.new_zeros((S, K, k))
        Gk.index_add_(1, ii, g[..., :k])
        Gk.index_add_(1, jj, -g[..., :k])
        L_x = L_x + pw * torch.nn.functional.pad(Gk, (0, nx - k))
        # Pair p = (i, j) adds H_p to blocks (i, i) and (j, j) and takes it
        # from (i, j) and (j, i) (cost.py:160-166).
        Hk = pw[..., None] * H[..., :k, :k]
        Hp = x.new_zeros((S, K, K, k, k))
        Hp[:, ii, jj] = -Hk
        Hp[:, jj, ii] = -Hk
        diag = x.new_zeros((S, K, k, k))
        diag.index_add_(1, ii, Hk)
        diag.index_add_(1, jj, Hk)
        ar = torch.arange(K, device=x.device)
        Hp[:, ar, ar] = diag
        Hb = x.new_zeros((S, K, nx, K, nx))
        Hb[:, :, :k, :, :k] = Hp.permute(0, 1, 3, 2, 4)
        L_xx = L_xx + Hb.reshape(S, K * nx, K * nx)
    L_x = L_x.reshape(S, K * nx)
    if u is None:
        return L_x, L_xx
    nu = u.shape[-1]
    RR = c["R"] + c["R"].transpose(-1, -2)
    L_u = (w[..., None] * torch.einsum("ski,skij->skj", u, RR)
           + 2.0 * (1.0 - m)[..., None] * u).reshape(S, K * nu)
    eye_u = torch.eye(nu, dtype=x.dtype, device=x.device)
    L_uu = _blockdiag(w[..., None, None] * RR + 2.0 * (1.0 - m)[..., None, None] * eye_u)
    return L_x, L_xx, L_u, L_uu


# ---------------------------------------------------------------- graph, gather

def interaction_graph(X, radius: float, n_pos, band: float = 1e-5, n_samples: int = 10):
    """Agents within ``2 radius`` of each other at any of about ten sampled
    knots of ``X (T, n, nx)`` (distributed.py:224-247): the ``(n, n)``
    membership (diagonal True) and, beside it, where a pair's distance lies
    within ``band`` (relative) of the threshold at a sampled knot, so that
    rounding may decide it."""
    T, n, nx = X.shape
    Xs = X[::max(T // n_samples, 1)]
    k = min(3, nx)
    pos = torch.nn.functional.pad(Xs[..., :k], (0, 3 - k))
    ii, jj = _pairs(n, X.device)
    n_pos = torch.as_tensor(n_pos, device=X.device)
    nd = torch.minimum(n_pos[ii], n_pos[jj])
    comp = (torch.arange(3, device=X.device) < nd[:, None]).to(X.dtype)
    delta = (pos[:, ii] - pos[:, jj]) * comp
    d = torch.sqrt(torch.sum(delta * delta, dim=-1))  # (samples, P)
    lim = 2.0 * radius
    close = torch.any(d < lim, dim=0)
    near = torch.any(torch.abs(d - lim) <= band * lim, dim=0)
    M = torch.eye(n, dtype=torch.bool, device=X.device)
    M[ii, jj] = M[jj, ii] = close
    tie = torch.zeros((n, n), dtype=torch.bool, device=X.device)
    tie[ii, jj] = tie[jj, ii] = near
    return M, tie


def gather_plan(M, K: int):
    """Each agent's subproblem: the owner in slot 0, then the other members
    in ascending order, cut to ``K`` slots (highest indices dropped);
    padded slots name the owner.  ``(idx (n, K) int64, member (n, K) bool)``."""
    n = M.shape[0]
    idx = torch.empty((n, K), dtype=torch.int64)
    member = torch.zeros((n, K), dtype=torch.bool)
    Mh = M.cpu().numpy()
    for i in range(n):
        others = [j for j in np.flatnonzero(Mh[i]) if j != i]
        row = [i] + others[:K - 1]
        idx[i] = i
        idx[i, :len(row)] = torch.as_tensor(row)
        member[i, :len(row)] = True
    return idx.to(M.device), member.to(M.device)


def gather(fleet_cost: dict, X0, U, idx, member):
    """The batch of subproblems of ``idx``/``member`` from a fleet's cost
    (fields of shape ``(n, ...)`` and scalars), states ``X0 (n, nx)`` and
    controls ``U (N, n, nu)``: ``(cost, x0 (n, K, nx), U (n, N, K, nu))``."""
    n, K = idx.shape
    mf = member.to(X0.dtype)
    c = {k: fleet_cost[k][idx] for k in ("xf", "Q", "R", "Qf", "n_pos", "n_pos_eval")}
    c["mask"] = mf * fleet_cost["mask"][idx]
    for k in ("radius", "prox_w", "ref_w"):
        c[k] = fleet_cost[k].expand(n).contiguous()
    Us = U[:, idx].transpose(0, 1) * mf[:, None, :, None]
    return c, X0[idx], Us


# ---------------------------------------------------------------- solve

def line_search_alphas(n: int, dtype, device):
    """``1.1^(-i^2)`` computed in float32, as the reference does (control.py:162)."""
    i = np.arange(n, dtype=np.float32)
    return torch.as_tensor(np.float32(1.1) ** (-(i ** 2)), device=device).to(dtype)


def _gauss_jordan(M, R):
    """``M^-1 R`` by Gauss-Jordan elimination without pivoting (for types
    that ``torch.linalg.solve`` does not take)."""
    M, R = M.clone(), R.clone()
    for p in range(M.shape[-1]):
        inv = 1.0 / M[:, p, p]
        rowM, rowR = M[:, p, :] * inv[:, None], R[:, p, :] * inv[:, None]
        col = M[:, :, p].clone()
        M = M - col[:, :, None] * rowM[:, None, :]
        R = R - col[:, :, None] * rowR[:, None, :]
        M[:, p, :], R[:, p, :] = rowM, rowR
    return R


def _solve(M, R):
    if M.dtype in (torch.float32, torch.float64):
        return torch.linalg.solve(M, R)
    return _gauss_jordan(M, R)


def backward(models, c: dict, X, U, mu, dt: float):
    """Gains ``Kg (S, N, nuf, nxf)`` and ``d (S, N, nuf)`` (control.py:116-148)."""
    S, Np1, K, nx = X.shape
    N, nu = Np1 - 1, U.shape[-1]
    nxf, nuf = K * nx, K * nu
    at_t = models if np.ndim(models) < 2 else np.asarray(models)[:, None]
    A, B = linearize(at_t, X[:, :-1], U, dt)  # (S, N, K, nx, nx), (S, N, K, nx, nu)
    B = B * c["mask"][:, None, :, None, None]
    eye = torch.eye(nxf, dtype=X.dtype, device=X.device)
    p, P = quadraticize(c, X[:, -1])
    Kg = X.new_zeros((S, N, nuf, nxf))
    dg = X.new_zeros((S, N, nuf))
    for t in range(N - 1, -1, -1):
        L_x, L_xx, L_u, L_uu = quadraticize(c, X[:, t], U[:, t])
        At = _blockdiag(A[:, t])
        Bt = _blockdiag(B[:, t])
        Preg = P + mu[:, None, None] * eye
        Q_x = L_x + torch.einsum("sij,si->sj", At, p)
        Q_u = L_u + torch.einsum("sij,si->sj", Bt, p)
        Q_xx = L_xx + At.transpose(1, 2) @ P @ At
        Q_uu = L_uu + Bt.transpose(1, 2) @ Preg @ Bt
        Q_ux = Bt.transpose(1, 2) @ Preg @ At
        sol = _solve(Q_uu, torch.cat([Q_ux, Q_u[..., None]], dim=-1))
        Kt, dt_ = -sol[..., :nxf], -sol[..., nxf]
        Kg[:, t], dg[:, t] = Kt, dt_
        KtT = Kt.transpose(1, 2)
        p = (Q_x + torch.einsum("sij,sj->si", KtT @ Q_uu, dt_)
             + torch.einsum("sij,sj->si", KtT, Q_u) + torch.einsum("sji,sj->si", Q_ux, dt_))
        P = Q_xx + KtT @ Q_uu @ Kt + KtT @ Q_ux + Q_ux.transpose(1, 2) @ Kt
        P = 0.5 * (P + P.transpose(1, 2))
    return Kg, dg


def forward(models, c: dict, X, U, Kg, dg, alphas, dt: float):
    """Closed-loop rollouts ``u = U + Kg (x - X) + alpha d`` for every alpha:
    ``Xc (A, S, N+1, K, nx)``, ``Uc (A, S, N, K, nu)``, ``Jc (A, S)``."""
    S, Np1, K, nx = X.shape
    N, nu = Np1 - 1, U.shape[-1]
    nA = alphas.shape[0]
    x = X[:, 0].expand(nA, S, K, nx)
    Xs, Us = [x], []
    J = X.new_zeros((nA, S))
    for t in range(N):
        dx = (x - X[:, t]).reshape(nA, S, K * nx)
        du = torch.einsum("snm,asm->asn", Kg[:, t], dx) + alphas[:, None, None] * dg[:, t]
        u = U[:, t] + du.reshape(nA, S, K, nu)
        J = J + stage_cost(c, x, u)
        x = step(models, x, u, dt)
        Xs.append(x)
        Us.append(u)
    J = J + terminal_cost(c, x)
    return torch.stack(Xs, dim=2), torch.stack(Us, dim=2), J


def solve(models, c: dict, x0, U0, dt: float, n_lqr_iter: int, tol: float,
          n_ls_iter: int = 10, mu_init: float = 1.0, delta_0: float = 2.0,
          mu_min: float = 1e-6, enabled=None):
    """The batched iLQR from the warm start ``U0 (S, N, K, nu)`` at ``x0 (S,
    K, nx)``; ``models`` one name a slot ``(K,)``, serving every
    subproblem, or of each subproblem ``(S, K)``.  A subproblem that ``enabled (S,)`` leaves out
    returns its warm start rolled out, with no iteration.  Returns a dict:
    ``X``, ``U``, ``J`` (the accepted plan and its cost), ``J0`` (the warm
    start's cost), ``iters``, ``converged``, ``failed`` (the line search
    found no lower cost)."""
    S = x0.shape[0]
    X = rollout(models, x0, U0, dt)
    U = U0.clone()
    J = trajectory_cost(c, X, U)
    J0 = J.clone()
    dtype, dev = x0.dtype, x0.device
    mu = torch.full((S,), mu_init, dtype=dtype, device=dev)
    delta = torch.full((S,), delta_0, dtype=dtype, device=dev)
    iters = torch.zeros((S,), dtype=torch.int32, device=dev)
    conv = torch.zeros((S,), dtype=torch.bool, device=dev)
    failed = torch.zeros((S,), dtype=torch.bool, device=dev)
    active = torch.full((S,), n_lqr_iter > 0, dtype=torch.bool, device=dev)
    if enabled is not None:
        active &= enabled.to(device=dev, dtype=torch.bool)
    alphas = line_search_alphas(n_ls_iter, dtype, dev)
    tiny = torch.finfo(dtype).tiny
    while bool(active.any()):
        a = torch.nonzero(active).flatten()
        ca = {k: v[a] for k, v in c.items()}
        ma = lanes(models, a)
        Kg, dg = backward(ma, ca, X[a], U[a], mu[a], dt)
        Xc, Uc, Jc = forward(ma, ca, X[a], U[a], Kg, dg, alphas, dt)
        improved = Jc < J[a][None]
        accept = improved.any(dim=0)
        first = torch.argmax(improved.to(torch.int32), dim=0)
        s = torch.arange(a.shape[0], device=dev)
        Jn = Jc[first, s]
        rel = torch.abs((J[a] - Jn) / torch.clamp(torch.abs(J[a]), min=tiny))
        up = a[accept]
        X[up] = Xc[first, s][accept]
        U[up] = Uc[first, s][accept]
        J[up] = Jn[accept]
        dd = torch.clamp(delta[up], max=1.0) / delta_0
        m = mu[up] * dd
        mu[up] = torch.where(m <= mu_min, torch.zeros_like(m), m)
        delta[up] = dd
        iters[a] += 1
        conv_now = accept & (rel < tol)
        conv[a] |= conv_now
        failed[a] |= ~accept
        active[a] = ~conv_now & accept & (iters[a] < n_lqr_iter)
    return {"X": X, "U": U, "J": J, "J0": J0, "iters": iters, "converged": conv,
            "failed": failed}
