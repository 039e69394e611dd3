"""Work counts and peaks of the kernels' rooflines: a frozen copy of the
program's ``utils/sol.py`` (``sweep_work``, ``published_bound`` and what
they call, as of the benchmark's first version), so that a later change to
the program cannot change the yardstick.

What is counted is what the algorithm needs on these shapes, MAC = 2
FLOPs: each input byte read once and each output byte written once,
whatever a kernel re-reads.  One backward count serves K1 and K3 (their
common recursion in ``csrc/riccati.cuh`` and the inputs they compute); one
forward count serves K2.  The peaks are those NVIDIA publishes for one H100
SXM (dense, without sparsity, at the full 700 W power limit): 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

PUBLISHED_FP32_FLOPS = 67e12
PUBLISHED_HBM_BYTES_S = 3.35e12


class ModelWork(NamedTuple):
    """Work of one model's continuous dynamics, counted from ``rhs`` in
    csrc/dynamics.cuh: one FLOP per +, -, *, / and unary minus of one
    evaluation for one slot, its sin/cos/tan evaluations, the RK4 substeps
    of one control period, and the FLOPs of its continuous Jacobian's
    nonzero partials in closed form beyond the right-hand side's own sines
    and cosines (a constant partial costs nothing; d tan = 1 + tan^2)."""

    f_flops: int
    f_trig: int
    substeps: int
    jac_flops: int


MODEL_WORK = {
    # x2, x3, u0, u1: no arithmetic.
    "DoubleInt4D": ModelWork(f_flops=0, f_trig=0, substeps=5, jac_flops=0),
    "DoubleInt6D": ModelWork(f_flops=0, f_trig=0, substeps=5, jac_flops=0),
    # u0 cos(x2), u0 sin(x2); partials -u0 sin, u0 cos.
    "Car3D": ModelWork(f_flops=2, f_trig=2, substeps=5, jac_flops=3),
    # x2 cos(x3), x2 sin(x3); partials -x2 sin, x2 cos.
    "Unicycle4D": ModelWork(f_flops=2, f_trig=2, substeps=5, jac_flops=3),
    # x3 cos(u0), x3 sin(u0); partials -x3 sin, x3 cos.
    "Human6D": ModelWork(f_flops=2, f_trig=2, substeps=5, jac_flops=3),
    "HumanLin6D": ModelWork(f_flops=0, f_trig=0, substeps=5, jac_flops=0),
    # g tan(u2), -g tan(u1), u0 - g; partials +-g (1 + tan^2).
    "Quad6D": ModelWork(f_flops=3, f_trig=2, substeps=5, jac_flops=6),
    # Rows xd0..xd11: 14 + 15 + 8 + 5 + 3 + 6 + 5 + 7 + 8 + 4 + 4 + 4; sin and
    # cos of three angles and one tan.  Partials by row: 32 + 32 + 16 + 12 +
    # 4 + 12 + 3 + 6 + 6 + 4 + 4 + 4.
    "Quad12D": ModelWork(f_flops=83, f_trig=7, substeps=5, jac_flops=135),
    # x2 cos(x3), x2 sin(x3), x2 tan(x4); partials -x2 sin, x2 cos,
    # x2 (1 + tan^2).
    "Bike5D": ModelWork(f_flops=3, f_trig=3, substeps=1, jac_flops=6),
}


def model_work(model: str) -> ModelWork:
    """The dynamics work of ``model`` (a ModelSpec name); a model whose
    right-hand side has not been counted raises."""
    if model not in MODEL_WORK:
        raise KeyError(
            f"no work count for model {model!r}: count its rhs in "
            f"csrc/dynamics.cuh and add a MODEL_WORK row (have {sorted(MODEL_WORK)})"
        )
    return MODEL_WORK[model]


def _models(model, K: int) -> tuple[str, ...]:
    """``model`` as one name per slot: a name (every slot) or a sequence."""
    names = (model,) * K if isinstance(model, str) else tuple(model)
    if len(names) != K:
        raise ValueError(f"{len(names)} model names for {K} slots")
    return names


def pair_flops(k: int) -> int:
    """FLOPs of one pair's proximity terms at one step (derivatives.cuh
    ``pair_terms``) and their share of the sums: the difference (3), its
    square norm (5), the root, activity, weight and clamp (4), the two
    scales (6), the Hessian's k^2 entries (4 each), the gradient scale (3)
    and vector (3), the two agents' gradient sums (2 k), the weighted
    Hessian (k^2) and the two agents' diagonal sums (2 k^2)."""
    return 24 + 7 * k * k + 2 * k


def sweep_prep_flops(K: int, nx_p: int, nu_p: int, model="Unicycle4D",
                     terminal: bool = False) -> tuple[int, int]:
    """``(flops, sin/cos/tan evaluations)`` of a backward kernel's inputs at
    one step of a problem of ``K`` agents or slots (K5's problem, a
    subproblem of K1 or K3; ``model``: a name or one per agent): the
    Euler-discretized Jacobians (the model's partials, ``I + dt A_c``,
    ``dt B_c m``), the cost gradients (``w (Q + Q^T)^T e`` and the
    proximity sum; ``w (R + R^T)^T u + 2 (1 - m) u``), every pair's terms and
    the diagonal blocks' proximity sums added into L_xx.  At the terminal
    step no Jacobians and no control terms."""
    k = min(3, nx_p)
    works = [model_work(m) for m in _models(model, K)]
    fl = K * (2 * nx_p * nx_p + 2 * nx_p + 2 * k)  # L_x
    fl += K * (K - 1) // 2 * pair_flops(k) + K * k * k  # pairs, L_xx's diagonal
    if terminal:
        return fl, 0
    fl += K * (2 * nu_p * nu_p + 4 * nu_p)  # L_u
    fl += sum(w.jac_flops for w in works) + K * (2 * nx_p * nx_p + 2 * nx_p * nu_p)
    return fl, sum(w.f_trig for w in works)


def backward_step_flops(K: int, nx_p: int, nu_p: int) -> int:
    """FLOPs of ONE time step of the Riccati sweep for ONE (sub)problem of
    ``K`` slots (``riccati_sweep_from`` in csrc/riccati.cuh; K1, K3, and K5
    with K = n).  nxf = K*nx_p, nuf = K*nu_p."""
    nxf, nuf = K * nx_p, K * nu_p
    fl = 0
    fl += nxf  # P + mu I: mu on the diagonal
    fl += 2 * K * nx_p * nx_p + nxf  # Q_x = Lx + A_bd^T p
    fl += 2 * K * nx_p * nu_p + nuf  # Q_u = Lu + B_bd^T p
    fl += 2 * nx_p * nxf * nxf  # AtP = A_bd^T P
    fl += 2 * nx_p * nxf * nxf + nxf * nxf  # Q_xx = Lxx + AtP A_bd
    fl += 2 * nx_p * nuf * nxf  # W1 = B_bd^T (P + mu I)
    fl += 2 * nx_p * nuf * nxf  # Q_ux = W1 A_bd
    fl += 2 * nx_p * nuf * nuf + nuf * nuf  # Q_uu = W1 B_bd + Luu
    # Gauss-Jordan: nuf pivots over the (nuf + nxf + 1)-wide augmented
    # system: scale the pivot row (w mul), eliminate (2 w nuf).
    w = nuf + nxf + 1
    fl += nuf * (w + 2 * w * nuf)
    fl += 2 * nuf * nuf + nuf  # w = Q_uu d + Q_u
    fl += 2 * nuf * nxf * 2 + 2 * nxf  # p' = Q_x + K^T w + Q_ux^T d
    fl += 2 * nuf * nuf * nxf  # QuuK = Q_uu K
    # K^T QuuK + K^T Q_ux; Q_ux^T K is the transpose of the latter.
    fl += 2 * (2 * nuf * nxf * nxf)
    fl += 3 * nxf * nxf  # adds + symmetrization
    return fl


def forward_step_trig_ops(K: int, nx_p: int, nu_p: int, n_alpha: int,
                          substeps: int, f_trig_per_slot: int = 2) -> int:
    """sin/cos/tan evaluations of ONE time step of the forward sweep for ONE
    (sub)problem across its ``n_alpha`` candidates: ``4 * substeps``
    dynamics evaluations of ``f_trig_per_slot`` each per slot.  Counted
    apart from ``forward_step_flops`` because a ``sinf`` is a routine of
    many instructions, not one FLOP; its rate is ``measure_sin_ops``'s."""
    return substeps * 4 * f_trig_per_slot * K * n_alpha


def forward_step_flops(K: int, nx_p: int, nu_p: int, n_alpha: int,
                       substeps: int, f_flops_per_slot: int = 2,
                       gains: bool = True) -> int:
    """FLOPs of ONE time step of the forward (line-search) sweep for ONE
    (sub)problem across its ``n_alpha`` candidates (K2; K4 with K = n);
    without ``gains`` the plain rollout's: no gain product, no control
    update."""
    nxf, nuf = K * nx_p, K * nu_p
    C = K * n_alpha  # slot columns per (sub)problem
    fl = 0
    if gains:
        fl += 2 * nxf * nuf * n_alpha  # du = Kg dx
        fl += 3 * nu_p * C  # u = U + du + alpha * d
    # stage cost: two quadratic forms + mask/weight muls
    fl += (2 * nx_p * nx_p + 2 * nx_p) * C
    fl += (2 * nu_p * nu_p + 2 * nu_p) * C
    fl += 6 * C
    npairs = K * (K - 1) // 2
    fl += npairs * (3 * 3 * 2 + 8) * n_alpha  # pairwise penalty
    # RK4: 4 f evaluations + state combines per substep
    fl += substeps * (4 * f_flops_per_slot + 14 * nx_p) * C
    return fl


def forward_step_hbm_bytes(K: int, nx_p: int, nu_p: int, n_alpha: int,
                           dtype_bytes: int = 4, gains: bool = True) -> int:
    """Device-memory bytes per time step per (sub)problem of the forward
    kernels: the nominal X and U rows, the gain block and d read once (all
    alphas share them); one X and one U row written per alpha.  Without
    ``gains`` (the plain rollout) the U row is read and the X row written,
    nothing else."""
    nxf, nuf = K * nx_p, K * nu_p
    if not gains:
        return (nuf + nxf) * dtype_bytes
    n = nxf + nuf + nuf * nxf + nuf + n_alpha * (nxf + nuf)
    return n * dtype_bytes


def forward_fixed_hbm_bytes(K: int, nx_p: int, nu_p: int, n_alpha: int,
                            dtype_bytes: int = 4, sweep: bool = False) -> int:
    """Bytes per (sub)problem that do not grow with the horizon: the last
    nominal state row, the slot tables (model, substeps: int32; dh), the
    cost (xf, Q, R, Qf, mask, three scalars, n_pos_eval: int32) and J.  The
    centralized kernel (``sweep``) also writes the initial state of every
    alpha's trajectory."""
    nxf = K * nx_p
    n = (nxf + K + nxf + 2 * K * nx_p * nx_p + K * nu_p * nu_p + K + 3
         + n_alpha)
    if sweep:
        n += n_alpha * nxf
    return n * dtype_bytes + 3 * K * 4


def sweep_fixed_flops(K: int, nx_p: int, nu_p: int) -> int:
    """A backward kernel's work once a (sub)problem's sweep: Q + Q^T, Qf + Qf^T and R + R^T, and the
    weighted blocks w (Q + Q^T), w (Qf + Qf^T) (two products an entry) and
    w (R + R^T) + 2 (1 - m) I (three)."""
    return K * (2 * nx_p * nx_p + nu_p * nu_p) + K * (4 * nx_p * nx_p + 3 * nu_p * nu_p)


def sweep_hbm_bytes(N: int, K: int, nx_p: int, nu_p: int, dtype_bytes: int = 4) -> int:
    """Device-memory bytes of one problem of a backward kernel, which
    computes its inputs (K5's problem, one subproblem of K1 or K3): X and U
    read, the cost (xf, Q, R, Qf, mask, three scalars; n_pos and the model
    ids or branch indices int32), dt and mu read, K and d written."""
    nxf, nuf = K * nx_p, K * nu_p
    n_in = ((N + 1) * nxf + N * nuf + nxf + 2 * K * nx_p * nx_p
            + K * nu_p * nu_p + K + 3 + 2)
    n_out = N * (nuf * nxf + nuf)
    return (n_in + n_out) * dtype_bytes + 2 * K * 4


BACKWARD_FAMILIES = ("backward", "backward_wide", "backward_sweep")
FORWARD_FAMILIES = ("forward", "forward_sweep", "rollout_sweep")


def sweep_work(family: str, N: int, K: int, nx_p: int, nu_p: int, S: int,
               n_alpha: int, model="Unicycle4D",
               dtype_bytes: int = 4) -> tuple[int, int, int]:
    """``(flops, sin/cos/tan evaluations, device-memory bytes)`` of one
    launch of a kernel family.  The three backward families compute their
    inputs: ``backward`` (K1) and ``backward_wide`` (K3) over S subproblems
    of K slots and ``backward_sweep`` (K5: K = n agents, S = 1) each count
    the recursion (``backward_step_flops``) and its inputs
    (``sweep_prep_flops`` at each step and the terminal one,
    ``sweep_fixed_flops``) a problem, and read the trajectory and the cost
    (``sweep_hbm_bytes`` a problem; a batch reads dt once and its unique
    models' ids, int32, once); ``forward`` (K2) and ``forward_sweep`` (K4:
    S = 1) share the other; ``rollout_sweep`` is K4 without gains (S = 1, one
    column: ``n_alpha`` is read as 1).  ``model`` is a ModelSpec name or one
    per slot (a mixed batch: the forward count is the mean over them)."""
    if family in BACKWARD_FAMILIES:
        prep, trig = sweep_prep_flops(K, nx_p, nu_p, model)
        fl = ((backward_step_flops(K, nx_p, nu_p) + prep) * N
              + sweep_prep_flops(K, nx_p, nu_p, model, terminal=True)[0]
              + sweep_fixed_flops(K, nx_p, nu_p))
        by = sweep_hbm_bytes(N, K, nx_p, nu_p, dtype_bytes) * S
        if family != "backward_sweep":
            by += 4 * len(set(_models(model, K))) - (S - 1) * dtype_bytes
        return fl * S, trig * N * S, by
    if family in FORWARD_FAMILIES:
        gains = family != "rollout_sweep"
        if not gains:
            n_alpha = 1
        names = _models(model, K)
        fl = trig = 0
        for name in names:
            w = model_work(name)
            fl += forward_step_flops(K, nx_p, nu_p, n_alpha, w.substeps, w.f_flops,
                                     gains)
            trig += forward_step_trig_ops(K, nx_p, nu_p, n_alpha, w.substeps, w.f_trig)
        fl, trig = fl * N * S // len(names), trig * N * S // len(names)
        by = (forward_step_hbm_bytes(K, nx_p, nu_p, n_alpha, dtype_bytes, gains) * N
              + forward_fixed_hbm_bytes(K, nx_p, nu_p, n_alpha, dtype_bytes,
                                        sweep=family != "forward")) * S
        return fl, trig, by + (n_alpha * dtype_bytes if gains else 0)  # the alphas
    raise ValueError(f"unknown kernel family {family!r}")


def published_bound(flops: float, bytes_: float, trig: float = 0.0):
    """The least time (seconds) an H100 SXM could take by its published
    peaks, and which bounds it: ``("bytes" | "operations")``.  A sin/cos/tan
    evaluation counts as one float32 instruction slot (the published rate
    is one FMA, two FLOPs, per slot), the least it can cost; the card
    publishes no rate for it."""
    t_ops = (flops + 2.0 * trig) / PUBLISHED_FP32_FLOPS
    t_bytes = bytes_ / PUBLISHED_HBM_BYTES_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"




def roofline_pct(device_s: float, flops: float, bytes_: float, trig: float = 0.0):
    """A kernel's share of its roofline, in %: the least time the card could
    take by its published peaks over the device time it took.  None where
    it took no time (nothing to read)."""
    if device_s <= 0.0:
        return None
    return 100.0 * published_bound(flops, bytes_, trig)[0] / device_s


def needed_work(run, role: str):
    """``(flops, trig, bytes)`` the traced slice's solves needed of one kernel
    role, ``backward`` or ``forward``: each subproblem's reported iterations
    times one sweep of a subproblem of its own neighbourhood (at most the
    step's width ``K``, where a neighbourhood was truncated: the owner and
    its lowest-numbered neighbours), each slot at its own agent's model.
    The width a solve was padded or compacted to is the program's choice,
    and its padded slots and lanes are waste, not work; so is the lane of
    an uncontrolled agent, which the solve leaves out.  An iteration's line
    search is counted at the probe's ``ls_probe`` alphas, the least that
    every iteration evaluates (which later alphas an iteration needed is not
    read from outside the program), and every solve's first rollout of its
    warm start at one alpha without gains.  ``run.trace.solves`` holds a
    traced step's or batch's ``(K, iters, graph rows)``, lane ``s`` owned
    by agent ``s % n``."""
    p = run.problem
    N, nx, nu = p.N, p.nx, p.nu
    probe = int(p.solver["ls_probe"]) or int(p.solver["n_ls_iter"])
    iters_at, solves_at = {}, {}
    for K, iters, rows in run.trace.solves:
        for s, (row, i) in enumerate(zip(np.asarray(rows), np.asarray(iters).tolist())):
            a = s % p.n
            if p.ignore_mask[a]:
                continue
            others = np.flatnonzero(row)
            members = [a] + others[others != a][:K - 1].tolist()
            key = tuple(sorted(p.models[members].tolist()))
            iters_at[key] = iters_at.get(key, 0) + int(i)
            solves_at[key] = solves_at.get(key, 0) + 1
    tot = [0, 0, 0]
    for key, its in iters_at.items():
        k = len(key)
        if role == "backward":
            w = [x * its for x in sweep_work("backward", N, k, nx, nu, 1, probe, key)]
        else:
            w = [x * its for x in sweep_work("forward", N, k, nx, nu, 1, probe, key)]
            r = sweep_work("rollout_sweep", N, k, nx, nu, 1, 1, key)
            w = [a + solves_at[key] * b for a, b in zip(w, r)]
        tot = [a + b for a, b in zip(tot, w)]
    return tuple(tot)


def role_roofline(run, role: str, kernels) -> float | None:
    """The share of its roofline, in %, of one kernel role over the traced
    slice: the needed work's published bound over the device time of the
    kernels whose names hold one of ``kernels``.  None where nothing was
    traced or no such kernel ran."""
    if run.trace is None or not run.trace.solves:
        return None
    flops, trig, bytes_ = needed_work(run, role)
    return roofline_pct(run.trace.time_of(kernels), flops, bytes_, trig)
