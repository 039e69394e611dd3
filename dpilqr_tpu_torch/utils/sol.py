"""Speed-of-light accounting for the port's CUDA kernels on one NVIDIA GPU.

Counterpart of ``dpilqr_tpu/utils/sol.py``.  For each kernel family it
counts the FLOPs, transcendental evaluations and device-memory bytes a
sweep needs, measures what this card achieves with three probes written the
same way as the kernels (hand-written CUDA, built and launched through
``ops/cuda_build.py``), and reports achieved against ceiling and which
limit binds:

- ``csrc/probe_fma.cu``: float32 FMA issue rate on register-resident data;
- ``csrc/probe_hbm.cu``: streaming read bandwidth of device memory;
- ``csrc/probe_sin.cu``: rate of ``sinf`` evaluations, the function the
  forward kernels call.

Beside the measured ceilings every report carries the bound against the
published peaks of an H100 SXM (NVIDIA's data sheet: 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s of HBM3), which assume the card's full
power limit.

What is counted.  The counts are what the ALGORITHM needs on these shapes,
MAC = 2 FLOPs: each input byte read once and each output byte written once,
whatever a kernel re-reads.  They follow the JAX package's counts term by
term and leave out the work that exists only on the TPU:

- backward: the dense ``P + mu * eye`` pass (``2 nxf^2``; the kernels add mu
  on the diagonal, ``nxf`` adds) and the one-hot blends that restore the
  pivot row in the Gauss-Jordan solve (``4 w`` per pivot; the kernels write
  the pivot row back);
- forward: the 0/1 row-extraction matmul of the gain product
  (``2 nu_p nuf C``; a thread reads its rows directly), and in the bytes
  the nominal X and U rows and d tiled once per alpha (``(n_alpha - 1)
  (nxf + 2 nuf)`` values a step; the kernels read them once for all alphas).

One backward count serves K1, K3 (``csrc/riccati.cuh`` is their common
arithmetic) and K5 with ``K = n`` agents and ``S = 1``; one forward count
serves K2, and K4 with ``S = 1``; K4 without gains (family ``rollout_sweep``:
the plain rollout of a fleet) is the same count less the gain product, the
gain bytes and the nominal trajectory, with one column.  Byte counts follow
the tensors the wrappers really pass (``ops/batched.py``, ``ops/sweeps.py``).

Each probe has a plain PyTorch version beside it (``probe_*_torch``) for the
tests; the wrappers (``probe_*_cuda``) take CUDA tensors only and never give
way to it.  All timing is CUDA events, the minimum of k >= 5 runs after a
warm-up.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SolverConfig, default_device
from ..models.fleet import homogeneous_fleet
from ..models.specs import QUAD_6D, UNICYCLE_4D
from ..ops import batched as bt
from ..ops import sweeps
from ..ops.costs import GameCost, make_game_cost
from ..ops.cuda_build import launch, launch_ms, require_cuda, timed_launches
from ..ops.ilqr import _backward_pass, line_search_alphas
from ..ops.pscan import backward_pass_pscan
from .profiling import cuda_min_ms

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), at its full
# 700 W power limit.
PUBLISHED_FP32_FLOPS = 67e12
PUBLISHED_HBM_BYTES_S = 3.35e12


# ---------------------------------------------------------------------------
# Work counts (per subproblem, per time step) for the sweeps.
# ---------------------------------------------------------------------------


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


def pscan_sweep_flops(N: int, nxf: int) -> int:
    """FLOPs of one associative-scan Riccati sweep (ops/pscan.py): a combine
    does 8 dense (nxf, nxf) matmuls (2 nxf^3 each) plus one Gauss-Jordan
    pass over the (nxf, 2 nxf + 1) augmented system (about 3 matmuls'
    worth); matvecs are negligible.  The scan runs about 2N combines."""
    return 2 * N * 11 * 2 * nxf**3


# ---------------------------------------------------------------------------
# The three probes: plain PyTorch versions and kernel wrappers.
# ---------------------------------------------------------------------------

# Launches between the two events of one timed run of a probe: a probe
# takes 0.1-0.5 ms, and the host's delay before the first launch of a run
# (tens of microseconds) must not show in its rate.
PROBE_REPS = 20
# The shape and iteration counts the ceilings are measured at.
PROBE_SHAPE, FMA_ITERS, SIN_ITERS, HBM_MB = (256, 512), 2048, 256, 256

# Instructions of one iteration (16 sines) of csrc/probe_sin.cu's loop on
# the path its arguments take, in the SASS of its sm_90a build: 390, 24.4 a
# sine (scripts/sass_count.py on an NVIDIA H100 80GB HBM3; the loop holds
# 1410 with the large-argument reductions it jumps over).
SIN_LOOP_SASS = 390

# Multiplier and addend of the four FMA chains a, b, c, d.
FMA_CONSTS = (1.0000001, 1.0000001e-7, 0.9999999, 1.0000002e-7,
              1.0000002, 0.9999998e-7, 0.9999998, 1.0000003e-7)


def probe_fma_torch(x, iters: int, consts=FMA_CONSTS):
    """Plain PyTorch version of ``csrc/probe_fma.cu``: four chains ``v = v *
    m_v + c_v``, 4 x ``iters`` times each, and ``(a + b) + (c + d)``.  Each
    step rounds twice where the kernel's fused multiply-add rounds once, so
    the two agree to float32 rounding at small ``iters`` only."""
    ma, ca, mb, cb, mc, cc, md, cd = consts
    a = x
    b = a * 1.0000001 + 0.0000003
    c = a * 0.9999999 + 0.0000001
    d = b * 1.0000002 + 0.0000002
    for _ in range(4 * iters):
        a = a * ma + ca
        b = b * mb + cb
        c = c * mc + cc
        d = d * md + cd
    return (a + b) + (c + d)


def probe_sin_torch(x, iters: int):
    """Plain PyTorch version of ``csrc/probe_sin.cu``: four chains ``v =
    sin(v)`` from a, 0.99 a, 1.01 a and 0.98 a, 4 x ``iters`` times each,
    and ``(a + b) + (c + d)``."""
    a, b, c, d = x, x * 0.99, x * 1.01, x * 0.98
    for _ in range(4 * iters):
        a, b, c, d = torch.sin(a), torch.sin(b), torch.sin(c), torch.sin(d)
    return (a + b) + (c + d)


def probe_hbm_torch(x):
    """Plain PyTorch version of ``csrc/probe_hbm.cu``: the sum over the
    leading axis."""
    return x.sum(0)


def _check_probe_input(name: str, x):
    require_cuda(name, x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous float32 tensor, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")


def probe_fma_cuda(x, iters: int, consts=FMA_CONSTS):
    """Launch ``csrc/probe_fma.cu`` on a float32 CUDA tensor of any shape;
    returns a tensor of the same shape."""
    _check_probe_input("probe_fma", x)
    out = torch.empty_like(x)
    launch("probe_fma", x.dtype, x.device, x, out, x.numel(), int(iters),
           *(float(v) for v in consts))
    return out


def probe_sin_cuda(x, iters: int):
    """Launch ``csrc/probe_sin.cu`` on a float32 CUDA tensor of any shape;
    returns a tensor of the same shape."""
    _check_probe_input("probe_sin", x)
    out = torch.empty_like(x)
    launch("probe_sin", x.dtype, x.device, x, out, x.numel(), int(iters))
    return out


def probe_hbm_cuda(x):
    """Launch ``csrc/probe_hbm.cu`` on a float32 CUDA tensor ``(T, ...)``
    whose trailing size is a multiple of 4; returns its sum over the leading
    axis."""
    _check_probe_input("probe_hbm", x)
    if x.ndim < 2:
        raise ValueError("probe_hbm takes (T, ...) with at least two axes")
    T = x.shape[0]
    m = x[0].numel()
    if m % 4 or x.data_ptr() % 16:
        raise ValueError("probe_hbm needs a trailing size that is a multiple "
                         "of 4 and 16-byte alignment")
    out = x.new_empty(x.shape[1:])
    launch("probe_hbm", x.dtype, x.device, x, out, T, m)
    return out


# ---------------------------------------------------------------------------
# Ceilings measured on this card.
# ---------------------------------------------------------------------------


def _device(device):
    dev = default_device() if device is None else torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"a ceiling is measured on a CUDA device, not on {dev}")
    return dev


class ProbeRun(NamedTuple):
    """One timed probe: the work of a launch, ``(flops, sines, bytes)`` from
    ``probe_work``, and the milliseconds a launch took."""

    work: tuple[int, int, int]
    ms: float


def probe_work(kernel: str, n: int, iters: int = 0, T: int = 1) -> tuple[int, int, int]:
    """``(flops, sinf evaluations, device-memory bytes)`` of one launch of a
    probe whose output has ``n`` float32 elements: ``probe_fma`` does 16 FMAs
    (32 FLOPs) and ``probe_sin`` 16 sines per element and iteration, each
    reading and writing ``n`` values; ``probe_hbm`` adds ``T`` slabs of ``n``
    values and writes one."""
    if kernel == "probe_fma":
        return 4 * 8 * n * iters, 0, 2 * n * 4
    if kernel == "probe_sin":
        return 0, 16 * n * iters, 2 * n * 4
    if kernel == "probe_hbm":
        return T * n, 0, (T + 1) * n * 4
    raise ValueError(f"unknown probe {kernel!r}")


def probe_sin_sass_bound_s(n: int, iters: int) -> float:
    """The least time of one ``probe_sin`` launch over ``n`` elements if
    each instruction its sine loop issues (``SIN_LOOP_SASS`` an iteration)
    took one FP32 issue slot at the published rate (half of 67 TFLOP/s):
    the bound that counts what an accurate ``sinf`` costs, beside
    ``published_bound``'s one slot a sine."""
    return n * iters * SIN_LOOP_SASS / (PUBLISHED_FP32_FLOPS / 2)


@functools.cache
def time_probe_fma(S: int = PROBE_SHAPE[1], rows: int = PROBE_SHAPE[0],
                   iters: int = FMA_ITERS, k: int = 5, device=None) -> ProbeRun:
    """Times ``csrc/probe_fma.cu`` on a (rows, S) operand of ones.  Measured
    once per argument set."""
    x = torch.ones((rows, S), dtype=torch.float32, device=_device(device))
    ms = cuda_min_ms(lambda: probe_fma_cuda(x, iters), reps=PROBE_REPS, k=k)
    return ProbeRun(probe_work("probe_fma", rows * S, iters), ms)


def measure_fma_peak_gflops(*args, **kwargs) -> float:
    """Achieved float32 GFLOP/s of ``csrc/probe_fma.cu`` (arguments as
    ``time_probe_fma``)."""
    run = time_probe_fma(*args, **kwargs)
    return run.work[0] / (run.ms * 1e-3) / 1e9


@functools.cache
def time_probe_sin(S: int = PROBE_SHAPE[1], rows: int = PROBE_SHAPE[0],
                   iters: int = SIN_ITERS, k: int = 5, device=None) -> ProbeRun:
    """Times ``csrc/probe_sin.cu`` on a (rows, S) operand of 0.7.  Measured
    once per argument set."""
    x = torch.full((rows, S), 0.7, dtype=torch.float32, device=_device(device))
    ms = cuda_min_ms(lambda: probe_sin_cuda(x, iters), reps=PROBE_REPS, k=k)
    return ProbeRun(probe_work("probe_sin", rows * S, iters), ms)


def measure_sin_ops(*args, **kwargs) -> float:
    """Achieved ``sinf`` evaluations per second of ``csrc/probe_sin.cu``
    (arguments as ``time_probe_sin``)."""
    run = time_probe_sin(*args, **kwargs)
    return run.work[1] / (run.ms * 1e-3)


class HbmTimes(NamedTuple):
    """One buffer streamed by ``csrc/probe_hbm.cu`` and by ``x.sum(0)``."""

    bytes: int  # read, the only bytes a rate counts
    kernel: ProbeRun
    library_ms: float


@functools.cache
def hbm_stream_times(mb: int = HBM_MB, k: int = 5, device=None) -> HbmTimes:
    """Times ``csrc/probe_hbm.cu`` and the library call ``x.sum(0)`` on the
    same (T, 512, 512) float32 buffer of ``mb`` MB, in turns (kernel,
    library, library, kernel).  Measured once per argument set."""
    blk = 512
    T = max(1, (mb * 1024 * 1024) // (blk * blk * 4))
    x = torch.ones((T, blk, blk), dtype=torch.float32, device=_device(device))
    turns = [probe_hbm_cuda, probe_hbm_torch, probe_hbm_torch, probe_hbm_cuda]
    ms = [cuda_min_ms(lambda fn=fn: fn(x), reps=PROBE_REPS, k=k) for fn in turns]
    run = ProbeRun(probe_work("probe_hbm", blk * blk, T=T), min(ms[0], ms[3]))
    return HbmTimes(T * blk * blk * 4, run, min(ms[1], ms[2]))


def measure_hbm_stream_gbps(*args, **kwargs) -> float:
    """Achieved streaming read bandwidth of ``csrc/probe_hbm.cu``, GB/s
    (arguments as ``hbm_stream_times``)."""
    t = hbm_stream_times(*args, **kwargs)
    return t.bytes / (t.kernel.ms * 1e-3) / 1e9


def _matmul_chain_gflops(shape, reps: int, k: int, device) -> float:
    """A chain of 8 data-dependent products ``x @ a`` of ``shape``."""
    m = shape[-1]
    dev = _device(device)
    a = (torch.eye(m, dtype=torch.float32, device=dev) * 0.999 + 0.001).expand(shape)
    a = a.contiguous()
    x = torch.ones(shape, dtype=torch.float32, device=dev)

    def chain():
        y = x
        for _ in range(8):
            y = torch.matmul(y, a)
        return y

    ms = cuda_min_ms(chain, reps=reps, k=k)
    return 8 * 2 * m * x.numel() / (ms * 1e-3) / 1e9


@functools.cache
def measure_matmul_peak_gflops(m: int = 1024, k: int = 5, device=None) -> float:
    """Achieved float32 FLOP/s of a chain of (m, m) @ (m, m) ``torch.matmul``
    products under the process's ``torch.backends.cuda.matmul.allow_tf32``
    setting (the one ``ops/pscan.py``'s combines run under).  A library
    call, not a kernel of this package: it is the yardstick of the scan's
    matmuls.  Returns GFLOP/s."""
    return _matmul_chain_gflops((m, m), 8, k, device)


@functools.cache
def measure_batched_matmul_gflops(nb: int = 400, m: int = 16, k: int = 5,
                                  device=None) -> float:
    """As ``measure_matmul_peak_gflops`` at the scan combine's own shapes: a
    chain of (nb, m, m) @ (nb, m, m) products, ``nb ~ 2N`` time-batched
    ``nxf x nxf`` blocks.  Returns GFLOP/s."""
    return _matmul_chain_gflops((nb, m, m), 16, k, device)


# ---------------------------------------------------------------------------
# Report.
# ---------------------------------------------------------------------------

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


def kernel_sol(family: str, N: int, K: int, nx_p: int, nu_p: int, S: int,
               n_alpha: int, measured_s: float, launches: int = 1,
               model: str = "Unicycle4D", dtype_bytes: int = 4) -> dict:
    """Achieved-vs-ceiling summary for ``launches`` sweeps of one kernel
    family measured at ``measured_s`` seconds in total.

    The binding limit is whichever ceiling predicts the LONGER time:
    ``t_compute = flops / fma_peak`` (plus, for the forward families,
    ``trig / sin_rate``: the sine routine runs on the same FMA pipes) against
    ``t_memory = bytes / hbm_bandwidth``, with the three ceilings measured
    on this card by the probes.  ``sol_frac`` is that time over the measured
    one.  ``bound_published_s`` is the same bound against the H100's
    published peaks (``published_bound``), ``published_frac`` its share.
    No field is rounded."""
    fl, trig, by = (v * launches for v in sweep_work(
        family, N, K, nx_p, nu_p, S, n_alpha, model, dtype_bytes))
    fma = measure_fma_peak_gflops() * 1e9
    hbm = measure_hbm_stream_gbps() * 1e9
    t_compute = fl / fma
    t_trig = trig_rate = 0.0
    if trig:
        trig_rate = measure_sin_ops()
        t_trig = trig / trig_rate
        t_compute += t_trig
    t_memory = by / hbm
    t_sol = max(t_compute, t_memory)
    t_pub, pub_by = published_bound(fl, by, trig)
    out = {
        "family": family,
        "gflops": fl / 1e9,
        "gbytes": by / 1e9,
        "achieved_gflop_s": fl / measured_s / 1e9,
        "achieved_gb_s": by / measured_s / 1e9,
        "ceiling_fma_gflop_s": fma / 1e9,
        "ceiling_hbm_gb_s": hbm / 1e9,
        "binding_limit": "fma" if t_compute >= t_memory else "hbm",
        "sol_s": t_sol,
        "measured_s": measured_s,
        "sol_frac": t_sol / measured_s,
        "bound_published_s": t_pub,
        "bound_published_by": pub_by,
        "published_frac": t_pub / measured_s,
    }
    if trig:
        out.update(
            trig_gops=trig / 1e9,
            ceiling_trig_gops_s=trig_rate / 1e9,
            trig_time_frac_of_sol=t_trig / t_sol,
        )
    return out


def _timed_wrapper(fn, kernel: str, k: int = 7):
    """``(kernel ms, wrapper ms)`` of ``fn``, a wrapper that launches
    ``kernel`` once: the minimum over ``k`` calls (after a warm-up) of the
    kernel's own time (events around the launch) and of the whole call."""
    fn()
    whole = []
    with timed_launches() as record:
        for _ in range(k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            whole.append((start, end))
    ms = launch_ms(record, kernel)
    if len(ms) != k:
        raise RuntimeError(f"expected {k} launches of {kernel}, saw {len(ms)}")
    return min(ms), min(s.elapsed_time(e) for s, e in whole)


def _report_problem(model_spec, K: int, S: int, N: int, dt: float,
                    radius: float, u_trim, u_scale: float, seed: int, dev):
    """A batch of ``S`` subproblems of ``K`` slots of one model, float32:
    starts scattered around the origin at unit spread (some pairs inside the
    radius, so the coupling blocks are exercised, while the line search's
    costs stay far from float32's range), goals elsewhere, and the nominal
    trajectory rolled out from small random controls about ``u_trim``."""
    dtype = torch.float32
    rng = np.random.default_rng(seed)
    fleet = homogeneous_fleet(model_spec, K, dt)
    nx_p, nu_p = fleet.nx_p, fleet.nu_p
    n_pos = model_spec.n_pos
    xf = np.zeros((K, nx_p))
    xf[:, :n_pos] = rng.normal(size=(K, n_pos))
    cost = make_game_cost(
        xf, np.tile(np.eye(nx_p), (K, 1, 1)), np.tile(np.eye(nu_p), (K, 1, 1)),
        np.tile(1e3 * np.eye(nx_p), (K, 1, 1)), radius=radius,
        n_pos=np.full((K,), n_pos, np.int32), dtype=dtype, device=dev)
    cost_b = GameCost(*(a[None].expand(S, *a.shape).contiguous() for a in cost))
    x0 = np.zeros((S, K, nx_p))
    x0[..., :n_pos] = rng.normal(size=(S, K, n_pos))
    U = (np.asarray(u_trim) + u_scale * rng.normal(size=(S, N, K, nu_p))
         ) * fleet.control_mask
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
    U = torch.as_tensor(U, dtype=dtype, device=dev)
    mids = torch.zeros((S, K), dtype=torch.int32, device=dev)
    carry = bt.init_batch_carry(fleet, SolverConfig(), cost_b, x0, U, mids,
                                torch.ones(S, dtype=torch.bool, device=dev), "cuda")
    return fleet, cost, cost_b, mids, carry.X, carry.U


def sol_report(device=None, n_alpha: int | None = None, k: int = 7) -> dict:
    """The accounting's main path on one card: runs the three probes, times
    each sweep kernel through its wrapper (the kernel's own time from events
    around the launch; the wrapper's torch preparation apart), and returns
    the ``kernel_sol`` reports.

    Shapes (float32, N = 50, dt = 0.1, radius 0.5): K1 and K2 at Unicycle4D,
    K = 8, S = 128, ``n_alpha`` line-search candidates (default: the
    ``SolverConfig`` default); K3 at Quad6D, K = 16, S = 64 (nxf 96, nuf 48);
    K5 and K4 at 10 unicycles, K4 without gains (the plain rollout) at 100
    unicycles; the associative scan at 4 unicycles and
    N = 200 beside the sequential PyTorch sweep and K5 on the same problem.
    Raises without a CUDA device."""
    dev = _device(device)
    with torch.cuda.device(dev):  # the ceilings measure on the current device
        return _sol_report(dev, n_alpha, k)


CEILINGS = (time_probe_fma, time_probe_sin, hbm_stream_times,
            measure_matmul_peak_gflops, measure_batched_matmul_gflops)


def _sol_report(dev, n_alpha, k):
    # A report's ceilings are measured in its own run, not remembered.
    for ceiling in CEILINGS:
        ceiling.cache_clear()
    n_alpha = DEFAULT_CONFIG.n_ls_iter if n_alpha is None else n_alpha
    N, dt, radius = 50, 0.1, 0.5
    alphas = line_search_alphas(n_alpha, torch.float32, dev)
    hbm = hbm_stream_times()
    report = {
        "device": torch.cuda.get_device_name(dev),
        "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "ceilings": {
            "fma_gflop_s": measure_fma_peak_gflops(),
            "hbm_gb_s": measure_hbm_stream_gbps(),
            "hbm_library_gb_s": hbm.bytes / (hbm.library_ms * 1e-3) / 1e9,
            "sin_gops_s": measure_sin_ops() / 1e9,
            "matmul_1024_gflop_s": measure_matmul_peak_gflops(),
        },
        # Each probe's timed launch: its work and its milliseconds.
        "probes": {"probe_fma": time_probe_fma(), "probe_hbm": hbm.kernel,
                   "probe_sin": time_probe_sin(), "hbm_library_ms": hbm.library_ms},
        "kernels": {},
    }

    def add(tag, kernel, family, fn, shape, model, finite):
        ms, whole = _timed_wrapper(fn, kernel, k)
        rep = kernel_sol(family, measured_s=ms * 1e-3, n_alpha=n_alpha,
                         model=model, **shape)
        rep.update(kernel=kernel, model=model, shape=dict(shape, n_alpha=n_alpha),
                   launch_ms=ms, prep_ms=whole - ms, outputs_finite=bool(finite))
        report["kernels"][tag] = rep

    # K1 and K2: the decomposed solve's narrow shape.
    fleet, _, cost_b, mids, X, U = _report_problem(
        UNICYCLE_4D, 8, 128, N, dt, radius, 0.0, 0.1, 0, dev)
    mu = torch.ones((128,), dtype=torch.float32, device=dev)
    shape = dict(N=N, K=8, nx_p=fleet.nx_p, nu_p=fleet.nu_p, S=128)
    Kg, d = bt.backward_pass_batched(fleet, cost_b, mids, X, U, mu, "cuda")
    add("K1", "backward_batched", "backward",
        lambda: bt.backward_pass_batched(fleet, cost_b, mids, X, U, mu, "cuda"),
        shape, "Unicycle4D", torch.isfinite(Kg).all() & torch.isfinite(d).all())
    J = bt.forward_pass_batched(fleet, cost_b, mids, X, U, Kg, d, alphas, "cuda")[2]
    add("K2", "forward_batched", "forward",
        lambda: bt.forward_pass_batched(fleet, cost_b, mids, X, U, Kg, d, alphas,
                                        "cuda"),
        shape, "Unicycle4D", torch.isfinite(J).all())

    # K3: the quadrotor swarm's wide shape (nxf 96, nuf 48), about hover.
    fleet3, _, cost3, mids3, X3, U3 = _report_problem(
        QUAD_6D, 16, 64, N, dt, radius, [9.80665, 0.0, 0.0], 0.01, 1, dev)
    mu3 = torch.ones((64,), dtype=torch.float32, device=dev)
    Kg3, d3 = bt.backward_pass_batched(fleet3, cost3, mids3, X3, U3, mu3, "cuda")
    add("K3", "backward_batched_wide", "backward_wide",
        lambda: bt.backward_pass_batched(fleet3, cost3, mids3, X3, U3, mu3, "cuda"),
        dict(N=N, K=16, nx_p=fleet3.nx_p, nu_p=fleet3.nu_p, S=64), "Quad6D",
        torch.isfinite(Kg3).all() & torch.isfinite(d3).all())

    # K5 and K4: one centralized problem of 10 unicycles.
    fleet5, cost5, _, _, X5, U5 = _report_problem(
        UNICYCLE_4D, 10, 1, N, dt, radius, 0.0, 0.1, 2, dev)
    X5, U5 = X5[0].contiguous(), U5[0].contiguous()
    mu5 = torch.tensor(1.0, dtype=torch.float32, device=dev)
    shape5 = dict(N=N, K=10, nx_p=fleet5.nx_p, nu_p=fleet5.nu_p, S=1)
    K5g, d5 = sweeps.backward_pass_cuda(fleet5, cost5, X5, U5, mu5)
    add("K5", "backward_sweep", "backward_sweep",
        lambda: sweeps.backward_pass_cuda(fleet5, cost5, X5, U5, mu5),
        shape5, "Unicycle4D", torch.isfinite(K5g).all() & torch.isfinite(d5).all())
    J4 = sweeps.forward_pass_cuda(fleet5, cost5, X5, U5, K5g, d5, alphas)[2]
    add("K4", "forward_sweep", "forward_sweep",
        lambda: sweeps.forward_pass_cuda(fleet5, cost5, X5, U5, K5g, d5, alphas),
        shape5, "Unicycle4D", torch.isfinite(J4).all())
    # K4 without gains: the plain rollout of a 100-unicycle fleet (the
    # stitched plan's joint cost on the decomposed path).
    fleet_r, cost_r, _, _, Xr, Ur = _report_problem(
        UNICYCLE_4D, 100, 1, N, dt, radius, 0.0, 0.1, 4, dev)
    x0_r, Ur = Xr[0, 0].contiguous(), Ur[0].contiguous()
    Jr = sweeps.rollout_cuda(fleet_r, cost_r, x0_r, Ur)[1]
    add("K4 rollout", "forward_sweep", "rollout_sweep",
        lambda: sweeps.rollout_cuda(fleet_r, cost_r, x0_r, Ur),
        dict(N=N, K=100, nx_p=fleet_r.nx_p, nu_p=fleet_r.nu_p, S=1), "Unicycle4D",
        torch.isfinite(Jr))

    # The associative scan at a long horizon, beside the sequential PyTorch
    # sweep and K5 on the same problem.
    n_ps, N_ps = 4, 200
    fleet_p, cost_p, _, _, Xp, Up = _report_problem(
        UNICYCLE_4D, n_ps, 1, N_ps, dt, radius, 0.0, 0.1, 3, dev)
    Xp, Up = Xp[0].contiguous(), Up[0].contiguous()
    nxf_p = n_ps * fleet_p.nx_p
    ms_ps = cuda_min_ms(
        lambda: backward_pass_pscan(fleet_p.linearize, cost_p, Xp, Up, mu5), k=5)
    ms_seq = cuda_min_ms(
        lambda: _backward_pass(fleet_p.linearize, cost_p, Xp, Up, mu5), k=5)
    ms_k5, whole_k5 = _timed_wrapper(
        lambda: sweeps.backward_pass_cuda(fleet_p, cost_p, Xp, Up, mu5),
        "backward_sweep", k)
    Kp, _ = backward_pass_pscan(fleet_p.linearize, cost_p, Xp, Up, mu5)
    Ks, _ = _backward_pass(fleet_p.linearize, cost_p, Xp, Up, mu5)
    fl_ps = pscan_sweep_flops(N_ps, nxf_p)
    fair = measure_batched_matmul_gflops(2 * N_ps, nxf_p)
    gflop_s = fl_ps / (ms_ps * 1e-3) / 1e9
    report["ceilings"]["matmul_batched_gflop_s"] = fair
    report["pscan"] = {
        "shape": dict(n=n_ps, N=N_ps, nxf=nxf_p),
        "pscan_ms": ms_ps, "sequential_torch_ms": ms_seq,
        "k5_launch_ms": ms_k5, "k5_wrapper_ms": whole_k5,
        "gflops": fl_ps / 1e9, "pscan_gflop_s": gflop_s,
        "pscan_sol_frac": gflop_s / report["ceilings"]["matmul_1024_gflop_s"],
        "pscan_sol_frac_fair": gflop_s / fair,
        "max_rel_err_vs_sequential": float(
            (Kp - Ks).abs().max() / Ks.abs().max()),
    }
    return report
