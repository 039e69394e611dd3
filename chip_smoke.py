#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's solve paths once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA device must be present; prints its name and
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. Build: compiles the hand-written kernels in ``dpilqr_tpu_torch/csrc``
   with nvcc, one process per source, and beside it the custom-model build
   of phase 8 (K1 to K5 with the right-hand side ``ops.codegen`` generates
   from a user bicycle's sympy field), both timed; prints K2's and K1's
   registers and spills in both builds.
3. Kernel vs plain PyTorch version, each timed with CUDA events (K1 and
   K3, the whole backward pass with its inputs computed in the kernel,
   against the torch prep plus the twin; float64 within 1e-11):
   a. K1, K3 and K2 at the 100-agent main path's shape (S=100
      subproblems, K=8 slots, nx_p=4, nu_p=2, N=50), float64 and float32
      (whether K1 and K3 agree bit for bit printed), forward with 2 and 10
      alphas, with and without gains; K1, K3 and K2 on a mixed
      DoubleInt4D+Car3D+Bike5D batch at K=4; K1 against K3 on the same
      float32 batches at nxf 4, 8, 16, 24 and 32 (K = 1, 2, 4, 6, 8: the
      narrow/wide routing datum) and K1 at batch widths S = 16, 32, 64 and
      128;
   b. K3 and the widened K2 on wide subproblems: Quad6D at K=8 (nxf 48)
      and at K=16 (nxf 96, nuf 48) and Quad12D at K=8 (nxf 96) from the
      64-agent quadrotor swarm (S=64), and Quad6D at K=32 (nxf 192, nuf 96:
      the width phase 4b's loop reaches; S=16), float64 and float32, 2 and 10
      alphas, each with K3's memory tier and the CTAs of a subproblem;
      every timed shape is printed beside its bound by the published
      peaks;
   c. K5 (the whole backward pass, its inputs computed in the kernel) on
      10 Unicycle4D at N=50 and N=200, one agent of each of the nine models,
      16 Quad6D and 32 Unicycle4D (its working set in the device workspace),
      float64 and float32, each launch timed; K4 with gains (over 10 alphas)
      at the 10-agent centralized shape, and K4 without gains, the plain
      rollout, against both its plain versions at the stitched plans'
      shapes: 10 and 100 Unicycle4D, 64 Quad6D, 500 Unicycle4D and a mixed
      DoubleInt4D+Car3D+Bike5D fleet, float64 and float32, J bit-equal in two
      runs, timed beside the torch loop it replaces (whole wrapper, and the
      launch alone).
4. Solve paths, each driven with the launch counts set to 0 just before
   and read just after:
   a. main path: ``solve_rhc(centralized=False)`` for 100 Unicycle4D
      agents, float32, 5 MPC steps, on the kernels and again on the twins,
      and once more with every launch timed (the graph's launches then run
      one by one): K1's, K2's, the accept kernel's and K4's launches
      and milliseconds per step by batch width S (the widths the retirement
      schedule really runs; K4, each solve's stitched-plan rollout, by its
      agents); the torch prep's calls and milliseconds a step on the kernel
      path (it must be 0) and on the twins; the CUDA kernels of one replayed
      batched iteration (its CUDA graph) counted by ``torch.profiler`` in a
      process of its own, at ``ls_probe`` 2 and 0: K1 once, K2 twice (probe
      and tail; once unsplit), the accept kernel once, nothing else, and one
      device-to-host copy, the host's one sync an iteration;
   b. the 64-agent Quad6D swarm closed loop at auto K (a truncated step
      fails the run), 5 MPC steps on the kernels, with K3's, K2's and K4's
      launches by batch width; once more at K=16 (nxf 96), 2 steps at K=16
      on the twins, and the auto-K loop in float64 on the kernels beside the
      float32 one (``noise_limited`` where float64 iterates a third more),
      which must reach K=32 (nxf 192: its neighbourhoods reach 17; float32's
      reach 15 to 17 with its rounding, and its K is printed);
   c. one cold ``solve_distributed`` of 64 Quad12D agents at K=8, float32,
      on the kernels; fails if it is not a solve (mean iterations <= 1);
      again in float64 and in float32 with ``mu_floor``, each beside the
      bar (mean iterations >= 5 and converged fraction > 0.5);
   d. ``ilqr_solve`` for 10 agents on the kernels and on the twins, float32
      (no quality datum at its tol=1e-9) and float64; the CUDA kernels of
      one centralized iteration counted by ``torch.profiler`` (K5, K4 and
      the accept step's elementwise kernels, nothing else); then
      ``solve_rhc(centralized=True)`` for 5 MPC steps on the kernels.
5. Float64 solve parity of kernels and twins (equal iterations and
   converged flags, J and X close): a narrow and a wide decomposed solve,
   and ``ilqr_solve``; the stitched J (K4's, step by step) within 1e-12
   relative of its time-batched plain version.
6. Speed-of-light accounting and the deadline solve:
   a. the three ceiling probes K6-K8 (``utils/sol.py``) against their plain
      PyTorch versions at the shapes ``sol_report`` launches them at: K7 on
      a seeded (256, 512, 512) buffer (and at 37 slabs), K8 at 256
      iterations (and at 3), K6 at 8 iterations (fused and unfused
      multiply-adds drift apart over the timed 2048);
   b. ``sol_report``: the probes timed at full size: float32 FMA GFLOP/s,
      HBM GB/s (beside ``x.sum(0)`` on the same buffer) and ``sinf``/s;
      fails on a rate over 105% of the H100's published peak (67 TFLOP/s,
      3.35 TB/s) or a sine rate above the FMA instruction rate; K1-K5 timed
      at its shapes (events around the launch alone), each with FLOPs,
      bytes, the bound from the measured ceilings and from the published
      peaks, its share and the binding limit; the
      associative scan beside the sequential sweep and K5; then each
      kernel's launches per MPC step and per centralized solve from phase 4;
   c. the 100-agent main path for 5 steps under ``t_kill = dt = 0.1`` s, the
      host-sync cost per iteration, ``ilqr_solve_steppable`` on the 10-agent
      problem under the same deadline, and in float64
      ``solve_distributed_steppable(t_kill=None)`` against
      ``solve_distributed``.
7. The reference-shaped facade (``dpilqr_tpu_torch.api``), Monte-Carlo
   trials and the custom-model guard, each path driven with the launch
   counts set to 0 just before and read just after:
   a. ``api.solve_rhc(centralized=False)`` for 100 ``UnicycleDynamics4D``
      in float64, 5 MPC steps: K1, K2 and K4 must launch, and X, U and J
      must have the bits of ``dpilqr_tpu_torch.solve_rhc`` on the same
      arrays; prints ms a step, mean iterations, converged fraction and J;
   b. ``api.ilqrSolver.solve`` and 3 steps of ``RecedingHorizonController``
      on phase 5's 10 unicycles: K5 and K4 must launch, each result
      bit-equal to ``ilqr_solve`` on the same input;
   c. ``solve_trials_sharded``: 8 trials of 100 Unicycle4D (seeds 0-7) at
      K=8 as one batch of S=800 on a one-card mesh, float64 and float32
      (first K1 on the trials' gathered batch of 800 against its plain
      version, timed in float32);
      trials 0, 3 and 7 against their own ``solve_distributed`` (float64:
      equal iterations and flags, X within the float64 tolerance; float32:
      J within its tolerance), the wall time beside 8 sequential solves, and
      K1's and K2's launches and ms a launch at S=800 beside their bound;
   d. a fleet of a custom model (a ``ModelSpec`` with its own ``f``) on the
      card: ``solve_distributed`` and ``ilqr_solve`` raise
      ``NotImplementedError`` with every launch count still 0.
   It also prints whether sympy, matplotlib and networkx are installed.
8. Custom (sympy) models on the card and the sharded solve, every failure
   fatal, each path driven with the launch counts set to 0 just before and
   read just after:
   a. K1 at K=6 (nxf 30) and K3 at K=8, K2 (2 and 10 alphas, with and
      without gains) at the main path's shape, K4 without gains at 100
      agents, K4 with gains and K5 at 10 agents, on fleets of the user
      bicycle (a ``SymbolicModel``, the custom-model build) against their
      plain versions, float64 and float32, each timed beside the same launch
      on ``Bike5D`` (whether the bits agree printed);
   b. the decomposed MPC loop of 100 user bicycles (one spec) at the main
      path's scenario, float32, 5 steps, K1, K2 and K4 (and K3 where it
      runs) from the custom build:
      equal K, mean iterations and converged fraction within 2% of the same
      loop on ``Bike5D``; then 2 steps in float64, equal iterations and
      flags, X within 1e-9;
   c. the facade's ``ilqrSolver.solve`` on 10 ``SymbolicModel`` bicycles (10
      model ids, one generated field), float64, against 10
      ``BikeDynamics5D`` and against the twins on the CPU (equal
      iterations, J within 1e-9); float32 through ``ilqr_solve``; 3 steps of
      ``api.solve_rhc(centralized=True)``; K5 and K4 only, from the custom
      build;
   d. one decomposed solve of 30 user bicycles, 40 Unicycle4D and 30 Car3D
      (K=8, packed at 0.55), float64: bit-equal to the same fleet with
      ``Bike5D`` for the bicycles, K3 from the custom build; one
      iteration's K3 and K2 against their plain versions; the twins' whole solve beside it, and beside itself from a warm
      start changed by 1e-13 (this packing's conditioning, printed);
   e. ``solve_distributed_sharded`` of 100 Unicycle4D packed at 0.55 (K=8,
      float64) on ``make_mesh()`` and in two chunks on the one card: bit-equal
      to ``solve_distributed``, compaction firing in every chunk (K1's and
      K2's widths printed by chunk).
9. The forward kernels past one stage: where a step's whole gain block does
   not fit a CTA beside its columns, K2 and K4 take it in tiles of rows
   (``column_launch`` in ``csrc/rollout.cuh``); every failure fatal, about a
   minute:
   a. K4 with gains on 100 Unicycle4D (swap scenario, spacing 1.25, N=50,
      10 alphas), float64 and float32, against ``_forward_pass``, timed (the
      launch alone) with its bound and its placement printed;
   b. K2 on Quad12D at K=32 (nxf 384, nuf 128), S=16, float64 (tiles) and
      float32 (one whole block), 2 and 10 alphas, against
      ``forward_pass_batched_torch``, timed with its bound;
   c. tiles forced (``max_rows``) where a whole block fits: K2 at the main
      path's shape (S=100, K=8, 10 alphas) and on Quad6D at K=16 (S=64), K4
      on 10 Unicycle4D, both types: the whole block's bits;
   d. ``ilqr_solve`` of a's 100 unicycles in float64 (``n_lqr_iter=5``: K5
      in tier 2, K4 in tiles) on the kernels beside the twins: K5 and K4
      launch and nothing else, iterations and flags equal, J within 1e-9
      relative, more than one iteration; then 2 steps of
      ``solve_rhc(centralized=True)`` in float32 on the kernels, ms a step;
   e. the forward plan (``cuda_build.forward_plan``, the kernels' own
      ``column_launch``) at every shape of a-c, and on each side of the
      one-column limit (1,709 and 1,710 Unicycle4D in float32, 854 and 855
      in float64).
10. ``bench_torch.py``: every point of the port's bench (``python3
    bench_torch.py --list``) through its ``main`` at full width, one timed
    repeat, closed loops of 3 MPC steps instead of 20 (15 at 500 agents),
    with the launch counts set to 0 just before and read just after: every
    kernel K1-K8 must launch, each point's line must hold its time with its
    minimum and maximum and its quality keys (``bench_torch.expected_keys``),
    each point's own launches must show its kernels (a ``cuda`` backend, no
    plain backward pass, K2 and K4 in every decomposed point, K4 and K5 in
    ``centralized_10``: ``bench_torch.card_faults``), no point may record an
    ``_error`` and the record's ``incomplete`` must be empty; prints each
    point's line, the launches and the phase's seconds.

11. The batched solve's device-side loop (runs last):
   a. the accept kernel (``csrc/accept_batched.cu``) against
      ``accept_batched_torch`` on random carries at the main path's shape
      (N=50, K=8, 10 alphas) at S = 100 and 800, float32 and float64, with
      and without the tail (its costs +inf), ``on_failed_ls`` "bail" and
      "increase" (with ``mu_floor``): the carry and the active count
      bit-equal; timed at S = 100 in float32 (50 launches replayed as one
      graph; the wrapper's call and the plain version's beside), with a
      bound by the bytes these inputs need;
   b. K2's tail under its predicate against the unpredicated launch at the
      main path's batch: bit-equal where an active subproblem needs the
      tail, J = +inf where none does, both types;
   c. the 100-agent main path, 5 MPC steps, on the graphs against the eager
      kernel path (``batched_iteration`` a width), float32 and float64: X,
      U, J, iterations and converged flags bit-equal and the same launches;
      ms a step both ways in turns (median, min-max of 3 runs each); the
      graph cache's entries and bytes; the device's busy share of a traced
      5-step loop (``bench_torch.device_busy``).

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the nine kernels with their launch counts, errors, times and bounds
(the least time by the published peaks, computed from the timed shapes;
K1-K5 also list every other shape they were timed at under ``shapes``, the
custom-model build's K1 to K5 among them, bound by ``Bike5D``'s work, and
K2's and K4's tiled shapes of phase 9;
K4's launches are summed over the decomposed and the centralized paths),
and the line before that the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The scenarios, the sympy bicycle and the host-sync timer are the bench's
# (one copy in the port).
import bench_torch
from bench_torch import grid3d_scenario, host_sync_us, swap_scenario, user_bike_class

N_AGENTS, HORIZON, DT, RADIUS = 100, 50, 0.1, 0.5
MPC_STEPS = 5
BENCH_MPC_STEPS = 3  # phase 10's closed loops (the bench's own: 20, 15 at 500 agents)
# Tolerances, relative to max|twin|.
TOL = {
    torch.float64: {"Kg": 1e-9, "d": 1e-9, "X5": 1e-9, "U5": 1e-9, "J": 1e-9},
    torch.float32: {"Kg": 2e-3, "d": 2e-3, "X5": 1e-4, "U5": 1e-4, "J": 1e-4},
}
# The kernels (launch-count keys of dpilqr_tpu_torch.ops.cuda_build).
KERNELS = {
    "backward_batched": ("backward_pass_batched", "dpilqr_tpu/ops/pallas_batched.py:396"),
    "forward_batched": ("forward_pass_batched", "dpilqr_tpu/ops/pallas_batched.py:540"),
    "backward_batched_wide": ("backward_pass_batched_wide",
                              "dpilqr_tpu/ops/pallas_batched_wide.py:115"),
    "forward_sweep": ("forward_pass_pallas", "dpilqr_tpu/ops/pallas_sweeps.py:178"),
    "backward_sweep": ("backward_pass_pallas", "dpilqr_tpu/ops/pallas_sweeps.py:399"),
    "probe_fma": ("measure_vpu_peak_gflops", "dpilqr_tpu/utils/sol.py:186"),
    "probe_hbm": ("measure_hbm_stream_gbps", "dpilqr_tpu/utils/sol.py:245"),
    "probe_sin": ("measure_vpu_transcendental_ops", "dpilqr_tpu/utils/sol.py:301"),
    # No Pallas kernel: the accept step XLA fuses into the batched iteration.
    "accept_batched": ("accept_batched", "dpilqr_tpu/ops/pallas_batched.py:1055-1097"),
}
PEAK_OVERSHOOT = 1.05  # a rate above this share of a published peak is a miscount


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def problem(fleet, x0_pos, xf_pos, dtype, dev, n_pos=2, pos=2):
    """Padded start and goal states and the game cost (Q = I, R = I,
    Qf = 1e3 I, radius 0.5) for ``fleet``."""
    import dpilqr_tpu_torch as dtt

    n, nx_p, nu_p = fleet.n_agents, fleet.nx_p, fleet.nu_p
    x0 = np.zeros((n, nx_p))
    x0[:, :pos] = x0_pos[:, :pos]
    xf = np.zeros((n, nx_p))
    xf[:, :pos] = xf_pos[:, :pos]
    cost = dtt.make_game_cost(
        xf, np.tile(np.eye(nx_p), (n, 1, 1)), np.tile(np.eye(nu_p), (n, 1, 1)),
        np.tile(1e3 * np.eye(nx_p), (n, 1, 1)), radius=RADIUS,
        n_pos=np.full((n,), n_pos, np.int32), dtype=dtype, device=dev,
    )
    return cost, x0


def unicycle_problem(n, spacing, dtype, dev):
    import dpilqr_tpu_torch as dtt

    x0, xf = swap_scenario(n, spacing)
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, DT)
    cost, x0 = problem(fleet, x0, xf, dtype, dev)
    return fleet, cost, x0


def quad_problem(model, n, spacing, dtype, dev):
    """The quadrotor swarm of ``bench.py`` (``quad6d_64``,
    ``quad12d_64_k8``): 3D positions, n_pos 3."""
    import dpilqr_tpu_torch as dtt

    fleet = dtt.homogeneous_fleet(model, n, DT)
    x0, xf = grid3d_scenario(n, spacing, fleet.nx_p)
    cost, x0 = problem(fleet, x0, xf, dtype, dev, n_pos=3, pos=3)
    return fleet, cost, x0


def rel_err(a, b):
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-300), float((a - b).abs().max())


def timed(fn, reps):
    """Mean ms per call over ``reps`` calls (CUDA events), after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Checks:
    """Kernel-vs-twin comparisons: prints each, fails beyond tolerance, and
    keeps each kernel's worst float32 absolute error, by the label of a
    timed launch its work (a ``work_shape``, or ``(FLOPs, sines, bytes)``
    for a probe), and by kernel the time of the one PyTorch call that
    computes the same function, where there is one."""

    def __init__(self):
        self.worst = {}
        self.shapes = {}
        self.library_ms = {}

    def compare(self, kernel, label, names, got, want, tol):
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, want):
            rel, ab = rel_err(a, b)
            print(f"{label} {name}: rel err {rel:.3e} (abs {ab:.3e}, tol {tol[name]:g})")
            if not rel <= tol[name]:
                fail(f"{kernel} disagrees with its twin on {name} ({label})")
            if a.dtype == torch.float32:
                self.worst[kernel] = max(self.worst.get(kernel, 0.0), ab)


def batch_inputs(fleet, cost, x0, U0, K, radius, dev):
    """Gathered subproblem batch of one decomposed solve step."""
    from dpilqr_tpu_torch.parallel.graph import interaction_graph
    from dpilqr_tpu_torch.parallel.subproblems import (
        gather_controls, gather_cost, gather_states, gather_subproblems,
    )

    dtype = cost.xf.dtype
    X = torch.as_tensor(x0, dtype=dtype, device=dev)[None]
    U = torch.as_tensor(U0, dtype=dtype, device=dev)
    M = interaction_graph(X, radius, n_pos=cost.n_pos)
    batch = gather_subproblems(M, K)
    sub_cost = gather_cost(cost, batch, dtype)
    branch = torch.as_tensor(fleet.branch_index_array, dtype=torch.int32, device=dev)
    return sub_cost, gather_states(X[0], batch), gather_controls(U, batch), branch[batch.member_idx]


def sweep_inputs(fleet, cost, x0, K, dev, seed=0, u_scale=0.01, u_trim=0.0):
    """A batch's backward-kernel arguments ``(fleet, sub_cost, mids, X, U,
    mu)`` and nominal trajectory: the rollout of a small random warm start
    (``u_trim`` plus uniform in [0, u_scale)), mu spread over [0.5, 1.5]."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt

    dtype = cost.xf.dtype
    rng = np.random.default_rng(seed)
    U0 = (u_trim + rng.uniform(size=(HORIZON, fleet.n_agents, fleet.nu_p))
          * u_scale) * fleet.control_mask
    sub_cost, x0_s, U_s, mids = batch_inputs(fleet, cost, x0, U0, K, RADIUS, dev)
    S = x0_s.shape[0]
    carry = bt.init_batch_carry(fleet, dtt.SolverConfig(), sub_cost, x0_s, U_s, mids,
                                torch.ones(S, dtype=torch.bool, device=dev), "torch")
    mu = torch.linspace(0.5, 1.5, S, dtype=dtype, device=dev)
    return (fleet, sub_cost, mids, carry.X, carry.U, mu), sub_cost, mids, carry


def plain_backward(args):
    """The plain version of K1 and K3 on a batch's arguments: the torch prep
    (``_quadraticize_batch``, ``_linearize_batch``) and the twin."""
    from dpilqr_tpu_torch.ops import batched as bt

    return bt.backward_pass_batched(*args, "torch")


def cut_args(args, sl):
    """The backward arguments of the subproblems ``sl`` of a batch."""
    fleet, sub_cost, mids, X, U, mu = args
    return (fleet, type(sub_cost)(*(a[sl].contiguous() for a in sub_cost)),
            *(a[sl].contiguous() for a in (mids, X, U, mu)))


def batch_width(args):
    return args[3].shape[0]


# K1 and K3 against their plain version in float64 (relative to max|plain|):
# the kernels compute the same inputs in another order of products only.
TOL_BACKWARD_F64 = {"Kg": 1e-11, "d": 1e-11}


def backward_tol(dtype):
    return TOL_BACKWARD_F64 if dtype == torch.float64 else TOL[dtype]


def work_shape(family, fleet, K, S, n_alpha=0, model=None):
    """The arguments ``utils.sol.sweep_work`` takes for a timed launch
    (``model``: the work-count model, by default the fleet's first)."""
    return dict(family=family, N=HORIZON, K=K, nx_p=fleet.nx_p, nu_p=fleet.nu_p,
                S=S, n_alpha=n_alpha, model=model or fleet.specs[0].name)


def bound_ms(work):
    """``(ms, "bytes" | "operations")``: the least time by the H100's
    published peaks for a timed launch's work, a ``work_shape`` of a sweep or
    a probe's ``(FLOPs, sines, bytes)``."""
    from dpilqr_tpu_torch.utils import sol

    flops, trig, nbytes = sol.sweep_work(**work) if isinstance(work, dict) else work
    bound_s, bound_by = sol.published_bound(flops, nbytes, trig)
    return bound_s * 1e3, bound_by


def print_result(checks, results, label):
    """One timed launch: the kernel's ms, its plain version's and its bound."""
    ms, plain = results[label]
    plain_s = "not timed" if plain is None else f"{plain:.3f}"
    bound_s = ""
    if label in checks.shapes:
        b_ms, by = bound_ms(checks.shapes[label])
        bound_s = f", bound {b_ms:.5f} by {by} (share {b_ms / ms:.5f})"
    print(f"{label} ms/launch: kernel {ms:.4f}, twin {plain_s}{bound_s}", flush=True)


def forward_checks(checks, results, tag, fleet, sub_cost, mids, carry, Kg, d,
                   dtype, dev, gains_off=True, model=None):
    """K2 against its twin at 2 and 10 alphas; times float32 with gains
    (``model``: the work-count model of its bound, as ``work_shape``)."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt

    for n_alpha in (2, 10):
        alphas = dtt.ops.line_search_alphas(n_alpha, dtype, dev)
        for gains in (True, False) if gains_off else (True,):
            fa = (fleet, sub_cost, mids, carry.X, carry.U,
                  Kg if gains else None, d if gains else None, alphas)
            checks.compare("forward_batched",
                           f"K2 {tag} {str(dtype)[6:]} alphas={n_alpha} gains={gains}",
                           ("X5", "U5", "J"), bt.forward_pass_batched_cuda(*fa),
                           bt.forward_pass_batched_torch(*fa), TOL[dtype])
            if dtype == torch.float32 and gains:
                results[f"K2 {tag} {n_alpha} alphas"] = (
                    timed(lambda: bt.forward_pass_batched_cuda(*fa), 10),
                    timed(lambda: bt.forward_pass_batched_torch(*fa), 2))
                checks.shapes[f"K2 {tag} {n_alpha} alphas"] = work_shape(
                    "forward", fleet, carry.X.shape[2], carry.X.shape[0], n_alpha,
                    model)


def narrow_checks(checks, results, dev):
    """Phase 3a: K1 and K2 at the main path's shape."""
    from dpilqr_tpu_torch.ops import batched as bt

    import dpilqr_tpu_torch as dtt

    for dtype in (torch.float64, torch.float32):
        # Spacing 0.55 packs the 100-agent scenario so that subproblems
        # fill most of their 8 slots (some stay padded) and proximity pairs
        # are active, while the closed loop stays well conditioned (denser
        # packings amplify a 1e-15 gain perturbation past 1e-9).
        fleet, cost, x0 = unicycle_problem(N_AGENTS, 0.55, dtype, dev)
        args, sub_cost, mids, carry = sweep_inputs(fleet, cost, x0, 8, dev)
        Kg_t, d_t = plain_backward(args)
        k1 = bt.backward_pass_batched_cuda(*args)
        checks.compare("backward_batched", f"K1 {str(dtype)[6:]}", ("Kg", "d"),
                       k1, (Kg_t, d_t), backward_tol(dtype))
        k3 = bt.backward_pass_batched_wide_cuda(*args)
        checks.compare("backward_batched_wide", f"K3 at nxf 32 {str(dtype)[6:]}",
                       ("Kg", "d"), k3, (Kg_t, d_t), backward_tol(dtype))
        print(f"K1 and K3 at nxf 32 {str(dtype)[6:]}: bit-equal {bits_agree(k1, k3)}",
              flush=True)
        if dtype == torch.float32:
            results["K1"] = (timed(lambda: bt.backward_pass_batched_cuda(*args), 20),
                             timed(lambda: plain_backward(args), 3))
            checks.shapes["K1"] = work_shape("backward", fleet, 8, batch_width(args))
            results["K3 at nxf 32"] = (
                timed(lambda: bt.backward_pass_batched_wide_cuda(*args), 20), None)
            checks.shapes["K3 at nxf 32"] = work_shape("backward_wide", fleet, 8,
                                                       batch_width(args))
        forward_checks(checks, results, "nxf 32", fleet, sub_cost, mids, carry,
                       Kg_t, d_t, dtype, dev)

    # The routing datum below nxf 32: K1 and K3 on the same float32 batches
    # (in turns: K1, K3, K3, K1; the smaller of each pair).
    fleet, cost, x0 = unicycle_problem(N_AGENTS, 0.55, torch.float32, dev)
    for K in (1, 2, 4, 6, 8):
        args = sweep_inputs(fleet, cost, x0, K, dev)[0]
        twin = plain_backward(args)
        fns = {"K1": bt.backward_pass_batched_cuda, "K3": bt.backward_pass_batched_wide_cuda}
        for name, fn in fns.items():
            checks.compare("backward_batched" if name == "K1" else "backward_batched_wide",
                           f"{name} routing nxf {4 * K}", ("Kg", "d"), fn(*args), twin,
                           TOL[torch.float32])
        ms = {name: [] for name in fns}
        for name in ("K1", "K3", "K3", "K1"):
            ms[name].append(timed(lambda fn=fns[name]: fn(*args), 20))
        for name in fns:
            results[f"{name} routing nxf {4 * K}"] = (min(ms[name]), None)
            checks.shapes[f"{name} routing nxf {4 * K}"] = work_shape(
                "backward", fleet, K, batch_width(args))

    # K1 at the batch widths the retirement schedule runs, cut from one
    # 128-agent batch: a launch should cost the same at each.
    fleet, cost, x0 = unicycle_problem(128, 0.55, torch.float32, dev)
    args = sweep_inputs(fleet, cost, x0, 8, dev)[0]
    for S in (16, 32, 64, 128):
        cut = cut_args(args, slice(0, S))
        checks.compare("backward_batched", f"K1 S={S}", ("Kg", "d"),
                       bt.backward_pass_batched_cuda(*cut), plain_backward(cut),
                       TOL[torch.float32])
        results[f"K1 S={S}"] = (timed(lambda: bt.backward_pass_batched_cuda(*cut), 20),
                                None)
        checks.shapes[f"K1 S={S}"] = work_shape("backward", fleet, 8, S)

    # Mixed RK4 substeps (Bike5D takes 1, the others 5); timed in float32
    # beside its bound (the slots' models averaged).  K1 at nxf 20 computes
    # the three models' Jacobians, K3 the same batch.
    fleet = dtt.Fleet.from_names(["DoubleInt4D", "Car3D", "Bike5D"] * 4, DT)
    x4, xf4 = swap_scenario(fleet.n_agents, 0.55)
    for dtype in (torch.float64, torch.float32):
        cost, x0 = problem(fleet, x4, xf4, dtype, dev)
        args, sub_cost, mids, carry = sweep_inputs(fleet, cost, x0, 4, dev, seed=1)
        Kg, d = plain_backward(args)
        checks.compare("backward_batched", f"K1 {str(dtype)[6:]} mixed K=4", ("Kg", "d"),
                       bt.backward_pass_batched_cuda(*args), (Kg, d), backward_tol(dtype))
        checks.compare("backward_batched_wide", f"K3 {str(dtype)[6:]} mixed K=4",
                       ("Kg", "d"), bt.backward_pass_batched_wide_cuda(*args), (Kg, d),
                       backward_tol(dtype))
        alphas = dtt.ops.line_search_alphas(10, dtype, dev)
        fa = (fleet, sub_cost, mids, carry.X, carry.U, Kg, d, alphas)
        checks.compare("forward_batched", f"K2 {str(dtype)[6:]} mixed-substeps",
                       ("X5", "U5", "J"), bt.forward_pass_batched_cuda(*fa),
                       bt.forward_pass_batched_torch(*fa), TOL[dtype])
    mixed = ("DoubleInt4D", "Car3D", "Bike5D", "DoubleInt4D")
    label = "K2 mixed DoubleInt4D+Car3D+Bike5D K=4 10 alphas"
    results[label] = (timed(lambda: bt.forward_pass_batched_cuda(*fa), 10), None)
    checks.shapes[label] = dict(work_shape("forward", fleet, 4, batch_width(args), 10),
                                model=mixed)
    label = "K1 mixed DoubleInt4D+Car3D+Bike5D K=4"
    results[label] = (timed(lambda: bt.backward_pass_batched_cuda(*args), 10), None)
    checks.shapes[label] = dict(work_shape("backward", fleet, 4, batch_width(args)),
                                model=mixed)


def wide_checks(checks, results, dev):
    """Phase 3b: K3 and the widened K2 on the quadrotor swarms."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt

    # The swarm grid packed at spacing 0.7 instead of 0.85, so that
    # proximity pairs are active and the coupling blocks are exercised (at
    # 0.85 no pair is inside the radius at the start); denser packings are
    # ill conditioned (at 0.6 a 1e-15 perturbation of A moves Quad6D's X by
    # 1e-9).  The nominal hovers (a free fall of 120 m over the horizon asks
    # for feedforward controls of ~1e5, whose closed loop diverges).
    # Quad12D's torque gains are ~6e4, so a random torque of 1e-6 already
    # spins it over within the horizon; its random part is 1e-7.
    # Quad6D at K=16 is the quad6d_64 loop's own shape (nxf 96, nuf 48); in
    # float64 its gain blocks exceed shared memory and K3 keeps them in
    # device memory too.
    g = 9.80665
    for model, K, u_scale, trim in (
            (dtt.QUAD_6D, 8, 0.01, [g, 0, 0]),
            (dtt.QUAD_6D, 16, 0.01, [g, 0, 0]),
            (dtt.QUAD_12D, 8, 1e-7, [0, 0, 0, g * 63 / 2000])):
        for dtype in (torch.float64, torch.float32):
            fleet, cost, x0 = quad_problem(model, 64, 0.7, dtype, dev)
            args, sub_cost, mids, carry = sweep_inputs(
                fleet, cost, x0, K, dev, u_scale=u_scale, u_trim=np.array(trim))
            tag = f"{model.name} K={K} nxf {K * fleet.nx_p}"
            Kg_t, d_t = plain_backward(args)
            checks.compare("backward_batched_wide", f"K3 {tag} {str(dtype)[6:]}",
                           ("Kg", "d"), bt.backward_pass_batched_wide_cuda(*args),
                           (Kg_t, d_t), backward_tol(dtype))
            if dtype == torch.float32:
                results[f"K3 {tag}"] = (
                    timed(lambda: bt.backward_pass_batched_wide_cuda(*args), 10),
                    timed(lambda: plain_backward(args), 2))
                checks.shapes[f"K3 {tag}"] = work_shape("backward_wide", fleet, K,
                                                        batch_width(args))
            elif K == 16:  # the gain blocks in device memory
                results[f"K3 {tag} float64"] = (
                    timed(lambda: bt.backward_pass_batched_wide_cuda(*args), 10), None)
            forward_checks(checks, results, tag, fleet, sub_cost, mids, carry,
                           Kg_t, d_t, dtype, dev, gains_off=False)
            print(f"{tag}: S={batch_width(args)}, nuf={K * fleet.nu_p}, "
                  f"{wide_tiers(K, fleet, dtype)}", flush=True)

    # Past nxf 96: Quad6D at K=32 (nxf 192, nuf 96), the width the quad6d_64
    # loop's auto K reaches.  Every fourth of the 64 subproblems (S = 16: the
    # twin's L_xx is 0.9 GB at S = 64 in float64).  K3 keeps all its matrices
    # in the workspace there and eliminates its 289-column tableau in place;
    # K2 stages two gain blocks in float32 and one in float64.
    for dtype in (torch.float64, torch.float32):
        fleet, cost, x0 = quad_problem(dtt.QUAD_6D, 64, 0.7, dtype, dev)
        args, sub_cost, mids, carry = sweep_inputs(
            fleet, cost, x0, 32, dev, u_scale=0.01, u_trim=np.array([g, 0, 0]))
        args = cut_args(args, slice(None, None, 4))
        sub_cost = type(sub_cost)(*(a[::4].contiguous() for a in sub_cost))
        carry = type(carry)(*(a[::4].contiguous() for a in carry))
        mids = mids[::4].contiguous()
        tag = f"Quad6D K=32 nxf 192 S={batch_width(args)}"
        print(f"{tag}: {wide_tiers(32, fleet, dtype)}", flush=True)
        Kg_t, d_t = plain_backward(args)
        checks.compare("backward_batched_wide", f"K3 {tag} {str(dtype)[6:]}",
                       ("Kg", "d"), bt.backward_pass_batched_wide_cuda(*args),
                       (Kg_t, d_t), backward_tol(dtype))
        suffix = "" if dtype == torch.float32 else " float64"
        results[f"K3 {tag}{suffix}"] = (
            timed(lambda: bt.backward_pass_batched_wide_cuda(*args), 3), None)
        if dtype == torch.float32:
            checks.shapes[f"K3 {tag}"] = work_shape("backward_wide", fleet, 32,
                                                    batch_width(args))
        forward_checks(checks, results, tag, fleet, sub_cost, mids, carry,
                       Kg_t, d_t, dtype, dev, gains_off=False)


def wide_tiers(K, fleet, dtype):
    """Where K3 places a subproblem: the tier of its working set and the
    CTAs of a subproblem."""
    from dpilqr_tpu_torch.ops import cuda_build

    item = torch.empty((), dtype=dtype).element_size()
    plan = cuda_build.riccati_plan(K, fleet.nx_p, fleet.nu_p, item, cuda_build.cluster_max())
    return f"K3 tier {str(dtype)[6:]}: {plan.tier}, {plan.cluster} CTA(s) a subproblem"


def centralized_inputs(dtype, dev):
    """The 10-agent centralized problem of ``bench.py`` (random_setup,
    energy 10, seed 12345)."""
    import dpilqr_tpu_torch as dtt

    rng = np.random.default_rng(12345)
    x0, xf = dtt.random_setup(10, 4, rng=rng, energy=10.0, n_d=2)
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 10, DT)
    cost, x0 = problem(fleet, x0, xf, dtype, dev)
    return fleet, cost, x0


G = 9.80665
# Hover controls of the models that fall without them (Quad6D thrust is u0,
# Quad12D's u3 with its thrust coefficient 2000/63).
HOVER = {"Quad6D": (0, G), "Quad12D": (3, G * 63 / 2000)}


def k5_problems(dtype, dev):
    """The fleets phase 3c holds K5 against its twin on: ``{name: (fleet,
    cost, X, U)}``, X the rollout of a small random warm start (about hover
    for the quadrotors).  10 Unicycle4D at N=50 (the centralized problem of
    phase 4d) and N=200; one agent of each of the nine models (padded to
    nx_p 12, nu_p 4: every Jacobian); 16 Quad6D; 32 Unicycle4D, whose
    working set lies in the device workspace (tier 1 or 2).  Quad12D's torque
    gains are ~6e4: its random part is 1e-7, as in phase 3b."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.models.specs import MODEL_REGISTRY
    from dpilqr_tpu_torch.ops import ilqr

    def nine(dtype, dev):
        fleet = dtt.Fleet.from_names([s.name for s in MODEL_REGISTRY], DT)
        ang = np.linspace(0, 2 * np.pi, fleet.n_agents, endpoint=False)
        pos = np.stack([np.cos(ang), np.sin(ang), 0.1 * np.sin(2 * ang)], -1) * 0.6
        n = fleet.n_agents
        cost, x0 = problem(fleet, pos, -pos, dtype, dev, pos=3)
        cost = cost._replace(n_pos=torch.as_tensor(fleet.n_pos, dtype=torch.int32,
                                                   device=dev))
        return fleet, cost, x0

    cases = {
        "10 Unicycle4D": (lambda: centralized_inputs(dtype, dev), HORIZON, 0.1),
        "9 models": (lambda: nine(dtype, dev), HORIZON, 0.01),
        "16 Quad6D": (lambda: quad_problem(dtt.QUAD_6D, 16, 0.7, dtype, dev), HORIZON, 0.01),
        "32 Unicycle4D": (lambda: unicycle_problem(32, 0.55, dtype, dev), HORIZON, 0.1),
        "10 Unicycle4D N=200": (lambda: unicycle_problem(10, 1.0, dtype, dev), 200, 0.01),
    }
    out = {}
    for name, (make, N, scale) in cases.items():
        fleet, cost, x0 = make()
        rng = np.random.default_rng(2)
        U = rng.uniform(size=(N, fleet.n_agents, fleet.nu_p)) * scale
        for i, spec in enumerate(fleet.specs):
            if spec.name == "Quad12D":
                U[:, i] *= 1e-7 / scale
            if spec.name in HOVER:
                U[:, i, HOVER[spec.name][0]] += HOVER[spec.name][1]
        U = torch.as_tensor(U * fleet.control_mask, dtype=dtype, device=dev)
        x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
        out[name] = (fleet, cost, ilqr._rollout_fn(fleet.step, cost, x0, U)[0], U)
    return out


def centralized_checks(checks, results, dev):
    """Phase 3c: K5 on its fleets (``k5_problems``) and K4 with gains at the
    10-agent centralized shape."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import cuda_build, ilqr, sweeps

    for dtype in (torch.float64, torch.float32):
        mu = torch.tensor(1.0, dtype=dtype, device=dev)
        for name, (fleet, cost, X, U) in k5_problems(dtype, dev).items():
            bw = (fleet, cost, X, U, mu)
            K_t, d_t = ilqr._backward_pass(fleet.linearize, cost, X, U, mu)
            tier = cuda_build.riccati_plan(fleet.n_agents, fleet.nx_p, fleet.nu_p,
                                           X.element_size()).tier
            checks.compare("backward_sweep", f"K5 {name} {str(dtype)[6:]} (tier {tier})",
                           ("Kg", "d"), sweeps.backward_pass_cuda(*bw), (K_t, d_t),
                           TOL[dtype])
            with cuda_build.timed_launches() as record:
                for _ in range(10):
                    sweeps.backward_pass_cuda(*bw)
            ms = min(cuda_build.launch_ms(record, "backward_sweep"))
            label = "K5" if name == "10 Unicycle4D" else f"K5 {name}"
            if dtype == torch.float64:
                label += " float64"
            twin = None
            if label == "K5":
                twin = timed(lambda: ilqr._backward_pass(fleet.linearize, cost, X, U, mu), 3)
            results[label] = (ms, twin)
            checks.shapes[label] = dict(work_shape("backward_sweep", fleet, fleet.n_agents,
                                                   1), N=U.shape[0],
                                        model=tuple(s.name for s in fleet.specs))
            print(f"{label}: {ms:.4f} ms a launch (tier {tier})", flush=True)

        fleet, cost, X, U0 = k5_problems(dtype, dev)["10 Unicycle4D"]
        K_t, d_t = ilqr._backward_pass(fleet.linearize, cost, X, U0, mu)
        alphas = dtt.ops.line_search_alphas(10, dtype, dev)
        fw = (cost, X, U0, K_t, d_t, alphas)
        checks.compare("forward_sweep", f"K4 10 alphas {str(dtype)[6:]}",
                       ("X5", "U5", "J"), sweeps.forward_pass_cuda(fleet, *fw),
                       ilqr._forward_pass(fleet.step, *fw), TOL[dtype])
        if dtype == torch.float32:
            results["K4 10 alphas"] = (
                timed(lambda: sweeps.forward_pass_cuda(fleet, *fw), 20),
                timed(lambda: ilqr._forward_pass(fleet.step, *fw), 3))
            checks.shapes["K4 10 alphas"] = work_shape("forward_sweep", fleet, 10, 1, 10)


def rollout_checks(checks, results, dev):
    """Phase 3c, second half: K4 without gains, the plain rollout every CUDA
    path takes, against ``_rollout_fn`` and ``_rollout_batched_cost`` at the
    stitched plans' shapes."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import cuda_build, ilqr, sweeps

    def mixed(dtype):
        fleet = dtt.Fleet.from_names(["DoubleInt4D", "Car3D", "Bike5D"] * 4, DT)
        x4, xf4 = swap_scenario(fleet.n_agents, 0.55)
        return (fleet, *problem(fleet, x4, xf4, dtype, dev))

    # Packed starts (spacing 0.55, the swarm at 0.7), so that pairs are
    # inside the radius and the pair term is exercised.
    cases = {
        "10 Unicycle4D": lambda dtype: centralized_inputs(dtype, dev),
        "100 Unicycle4D": lambda dtype: unicycle_problem(100, 0.55, dtype, dev),
        "64 Quad6D": lambda dtype: quad_problem(dtt.QUAD_6D, 64, 0.7, dtype, dev),
        "500 Unicycle4D": lambda dtype: unicycle_problem(500, 0.55, dtype, dev),
        "12 mixed": mixed,
    }
    for name, make in cases.items():
        for dtype in (torch.float64, torch.float32):
            fleet, cost, x0 = make(dtype)
            n = fleet.n_agents
            x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
            U = np.random.default_rng(5).uniform(size=(HORIZON, n, fleet.nu_p)) * 0.01
            if "Quad6D" in name:
                U[..., 0] += 9.80665  # hover
            U = torch.as_tensor(U * fleet.control_mask, dtype=dtype, device=dev)
            got = sweeps.rollout_cuda(fleet, cost, x0, U)
            tag = f"K4 rollout {name}"
            for twin in (ilqr._rollout_fn, ilqr._rollout_batched_cost):
                checks.compare("forward_sweep", f"{tag} {str(dtype)[6:]} vs {twin.__name__}",
                               ("X5", "J"), got, twin(fleet.step, cost, x0, U), TOL[dtype])
            if not float(got[1]) > 0:
                fail(f"{tag}: J is not positive")
            again = sweeps.rollout_cuda(fleet, cost, x0, U)
            if not (torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])):
                fail(f"{tag} {dtype}: two runs differ in bits")
            if dtype == torch.float32 and name != "12 mixed":
                def run():
                    return sweeps.rollout_cuda(fleet, cost, x0, U)

                results[tag] = (
                    timed(run, 20),
                    timed(lambda: ilqr._rollout_batched_cost(fleet.step, cost, x0, U), 2))
                with cuda_build.timed_launches() as record:
                    for _ in range(10):
                        run()
                results[f"{tag}, the launch alone"] = (
                    min(cuda_build.launch_ms(record, "forward_sweep")), None)
                for label in (tag, f"{tag}, the launch alone"):
                    checks.shapes[label] = work_shape("rollout_sweep", fleet, n, 1, 1)


def run_counted(fn):
    """``fn()`` with the launch counts set to 0 just before; returns its
    result and the counts read just after."""
    from dpilqr_tpu_torch.ops import cuda_build

    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(cuda_build.launch_counts)


# Where a launch's integer arguments hold its batch width S (K4: its agents n).
SIZE_OF_S = {"backward_batched": 0, "forward_batched": 0, "backward_batched_wide": 1,
             "forward_sweep": 0, "accept_batched": 0}


def launches_by_width(fn, steps, kernels):
    """``fn()`` (a run of ``steps`` MPC steps) with every kernel launch
    bracketed by CUDA events; for each of ``kernels`` the launches and the
    milliseconds per step at each batch width S (K2 also by its alphas; K4,
    the stitched plan's rollout, by its agents n)."""
    from dpilqr_tpu_torch.ops import cuda_build

    with cuda_build.timed_launches() as record:
        fn()
    torch.cuda.synchronize()
    out = {k: {} for k in kernels}
    for kernel, start, end, sizes in record:
        if kernel not in out:
            continue
        key = f"{'n' if kernel == 'forward_sweep' else 'S'}={sizes[SIZE_OF_S[kernel]]}"
        if kernel == "forward_batched":
            key += f" alphas={sizes[5]}"
        cell = out[kernel].setdefault(key, {"launches_per_step": 0.0, "ms_per_step": 0.0})
        cell["launches_per_step"] += 1 / steps
        cell["ms_per_step"] += start.elapsed_time(end) / steps
    for cells in out.values():
        for cell in cells.values():
            cell["ms_per_launch"] = cell["ms_per_step"] / cell["launches_per_step"]
    return out


def print_by_width(path, by_width):
    for kernel, cells in by_width.items():
        total = sum(c["ms_per_step"] for c in cells.values())
        n = sum(c["launches_per_step"] for c in cells.values())
        print(f"{path} {kernel} by width: {n:.1f} launches, {total:.3f} ms a step: "
              + json.dumps(cells), flush=True)


def rhc_run(fleet, cost, x0, backend, steps, centralized=False, K=None,
            t_kill=None, dtype=np.float32):
    """A closed-loop MPC run of ``steps`` steps in ``dtype`` (the cost's
    type must match); returns a summary.  Under auto K (``K`` None) a
    truncated step fails the run; with ``K`` pinned the summary counts them.
    With ``t_kill`` every step's solve runs under that deadline, and the
    summary says how many steps reached it."""
    import warnings

    import dpilqr_tpu_torch as dtt

    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        if K:  # pinned K: truncation warnings, counted below
            warnings.simplefilter("ignore", RuntimeWarning)
        res = dtt.solve_rhc(
            fleet, cost, x0.astype(dtype), HORIZON,
            radius=None if centralized else RADIUS, centralized=centralized,
            step_size=1, J_converge=1e-3, t_diverge=(steps - 1) * DT, K=K,
            t_kill=t_kill, config=cfg, rng=np.random.default_rng(0),
            device=cost.xf.device,
        )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(res.steps) < steps:
        fail(f"{backend}: only {len(res.steps)} MPC steps ran")
    if not all(np.isfinite(s.J) for s in res.steps) or not np.isfinite(res.J):
        fail(f"{backend}: non-finite J")
    truncated = sum(s.k_max > s.K for s in res.steps) if not centralized else 0
    if truncated and K is None:
        fail(f"{backend}: a step was truncated")
    if not np.isfinite(res.X).all():
        fail(f"{backend}: non-finite trajectory")
    iters = np.concatenate([np.asarray(s.iters) for s in res.steps])
    conv = np.concatenate([np.asarray(s.converged) for s in res.steps])
    deadline = {} if t_kill is None else {
        "t_kill": t_kill,
        "steps_at_deadline_frac": float(np.mean(
            [s.solve_time >= t_kill for s in res.steps])),
        "max_solve_ms": max(s.solve_time for s in res.steps) * 1e3,
    }
    return {
        **deadline,
        "ms_per_step": wall / len(res.steps) * 1e3,
        "steps": len(res.steps),
        "J_final_step": res.steps[-1].J,
        "J_executed": res.J,
        "K": [s.K for s in res.steps],
        "k_max": [s.k_max for s in res.steps],
        "truncated_steps": truncated,
        "mean_iters": float(iters.mean()),
        "converged_frac": float(conv.mean()),
        "converged_frac_by_step": [float(np.mean(np.asarray(s.converged)))
                                   for s in res.steps],
        "mean_iters_by_step": [float(np.mean(np.asarray(s.iters))) for s in res.steps],
    }


def require(counts, kernels, path, solves=0):
    """Fail unless the run launched every one of ``kernels`` and, where it is
    a run of ``solves`` decomposed solves, K4 at least once a solve (each
    solve's stitched plan is rolled out on it)."""
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        fail(f"{path} did not launch {missing}: {counts}")
    if counts["forward_sweep"] < solves:
        fail(f"{path}: {counts['forward_sweep']} launches of K4 for {solves} solves")


def no_sweep_kernel(counts):
    """Fail if a run on the twins (``sweep_backend="torch"``) launched a
    sweep kernel.  Its plain rollouts (the stitched and the executed cost) do
    go through K4: they pick by the tensors' device, not by the backend."""
    if any(n for k, n in counts.items() if k != "forward_sweep"):
        fail(f"the torch backend launched a sweep kernel: {counts}")
    if counts["forward_sweep"] <= 0:
        fail("the twins' run did not roll its stitched plans out on K4")


def torch_prep_per_step(run):
    """``run()`` (an MPC run) with the decomposed path's torch prep
    (``_quadraticize_batch``, ``_linearize_batch``) counted and timed (the
    device synchronized around each call): its calls and milliseconds a
    step."""
    from dpilqr_tpu_torch.ops import batched as bt

    names = ("_quadraticize_batch", "_linearize_batch")
    originals = {name: getattr(bt, name) for name in names}
    total = {"calls": 0, "ms": 0.0}

    def timed_call(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            total["calls"] += 1
            total["ms"] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    try:
        for name, fn in originals.items():
            setattr(bt, name, timed_call(fn))
        out = run()
    finally:
        for name, fn in originals.items():
            setattr(bt, name, fn)
    return {"prep_calls_per_step": total["calls"] / out["steps"],
            "prep_ms_per_step": total["ms"] / out["steps"],
            "ms_per_step_with_prep_synchronized": out["ms_per_step"]}


def batched_iteration_kernels(dev, ls_probe=2):
    """The CUDA kernels of one replayed iteration of the batched solve (the
    main path's, S=100 at K=8, float32, 10 alphas), counted by
    ``torch.profiler``, and its device-to-host copies (the host syncs):
    fails unless the replay runs K1 once, K2 twice (probe and tail; once
    where ``ls_probe`` does not split the alphas), the accept kernel once,
    nothing else, and one copy."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt
    from dpilqr_tpu_torch.ops.cuda_build import require_kernel_models

    fleet, cost, x0 = unicycle_problem(N_AGENTS, 0.55, torch.float32, dev)
    args, sub_cost, mids, carry = sweep_inputs(fleet, cost, x0, 8, dev)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, ls_probe=ls_probe)
    x0_s = carry.X[:, 0].contiguous()
    S, Np1, K, nx_p = carry.X.shape
    g = bt.iteration_graph(fleet, cfg, require_kernel_models(fleet), S, Np1 - 1, K, nx_p,
                           fleet.nu_p, torch.float32, dev)
    g.load(fleet, carry, (sub_cost, mids, x0_s))
    g.step()  # the first iteration: launched eagerly, then captured
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.step()
        torch.cuda.synchronize()
    # Kernels and copies; not the ranges of the program's spans, which the
    # profiler also projects onto the device's timeline.
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    copies = sum("memcpy" in e.name.lower() and "dtoh" in e.name.lower() for e in events)
    names = collections.Counter(e.name for e in events if "memcpy" not in e.name.lower()
                                and "memset" not in e.name.lower())
    k1 = sum(n for k, n in names.items() if "backward_batched_kernel" in k)
    k2 = sum(n for k, n in names.items() if "forward_batched_kernel" in k)
    acc = sum(n for k, n in names.items() if "accept_batched_kernel" in k)
    split = 0 < ls_probe < cfg.n_ls_iter
    out = {"ls_probe": ls_probe, "kernels": sum(names.values()), "K1": k1, "K2": k2,
           "accept": acc, "others": sum(names.values()) - k1 - k2 - acc,
           "device_to_host_copies": copies}
    print(f"one replayed batched iteration (S={S}, K=8), CUDA kernels "
          "(torch.profiler): " + json.dumps(out), flush=True)
    if not names:
        fail("torch.profiler saw no CUDA kernel in a replayed batched iteration")
    if (k1, k2, acc, out["others"]) != (1, 2 if split else 1, 1, 0):
        fail(f"a replayed batched iteration is not K1, K2 x{2 if split else 1} and "
             f"the accept kernel: {dict(names)}")
    if copies != 1:
        fail(f"a replayed batched iteration makes {copies} device-to-host copies, not 1")


def main_path(dev, launches):
    """Phase 4a: the 100-agent decomposed MPC loop."""
    fleet, cost, x0 = unicycle_problem(N_AGENTS, 1.25, torch.float32, dev)
    rhc_run(fleet, cost, x0, "cuda", MPC_STEPS)  # warm-up (allocator, cuBLAS)
    kern, counts = run_counted(lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS))
    path = ("backward_batched", "forward_batched", "accept_batched", "forward_sweep")
    require(counts, path, "the main path", solves=kern["steps"])
    for k in path:
        launches[k] = launches.get(k, 0) + counts[k]
    launches["per MPC step (100 unicycles)"] = {k: counts[k] / kern["steps"] for k in path}
    print("main path (kernels): " + json.dumps(kern), flush=True)
    print_by_width("main path", launches_by_width(
        lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS), MPC_STEPS, path))
    # The torch prep is gone from the kernel path; on the twins it runs.
    prep = {backend: torch_prep_per_step(
        lambda backend=backend: rhc_run(fleet, cost, x0, backend, MPC_STEPS))
        for backend in ("cuda", "torch")}
    print("main path, the torch prep a step (kernels, twins): " + json.dumps(prep),
          flush=True)
    if prep["cuda"]["prep_calls_per_step"] != 0:
        fail("the kernel path still runs the torch prep")
    # In processes of their own: a second torch.profiler session in one
    # process (phase 4d's) misses the kernels of the ctypes-loaded library.
    for ls_probe in (2, 0):
        child = subprocess.run(
            [sys.executable, "-c", "import torch, chip_smoke as cs; "
             f"cs.batched_iteration_kernels(torch.device('cuda', {dev.index or 0}), "
             f"{ls_probe})"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        print(child.stdout.strip(), flush=True)
        if child.returncode != 0:
            fail(f"the batched iteration's kernel count failed:\n{child.stderr[-2000:]}")
    twin, counts = run_counted(lambda: rhc_run(fleet, cost, x0, "torch", MPC_STEPS))
    no_sweep_kernel(counts)
    print("main path (torch twins): " + json.dumps(twin), flush=True)


def quad6d_loop(dev, launches):
    """Phase 4b: the quad6d_64 closed loop (bench.py:716) at auto K; a
    truncated step fails the run.  Auto K reaches 32 (nxf 192, nuf 96) once
    the planned trajectories' neighbourhoods outgrow 16: in float64 they
    reach 17 from the second step on, and the float64 loop must reach K=32;
    in float32 they end at 15 to 17 by the rounding of the Jacobians and
    cost derivatives (the plain version's prep: 15), so the float32 loop's K
    is printed, not held.  One more timed run pins K=16 (nxf 96), where steps
    with 17-agent neighbourhoods drop coupling partners: the shape earlier
    measurements of this loop were taken at."""
    import dpilqr_tpu_torch as dtt

    fleet, cost, x0 = quad_problem(dtt.QUAD_6D, 64, 0.85, torch.float32, dev)
    path = ("backward_batched_wide", "forward_batched", "forward_sweep")
    rhc_run(fleet, cost, x0, "cuda", MPC_STEPS)  # warm-up (the allocator at nxf 192)
    kern, counts = run_counted(lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS))
    require(counts, path, "the quad6d_64 loop", solves=kern["steps"])
    launches["backward_batched_wide"] = counts["backward_batched_wide"]
    launches["forward_sweep"] += counts["forward_sweep"]
    launches["per MPC step (64 Quad6D, auto K)"] = {
        k: counts[k] / kern["steps"] for k in path}
    print(f"quad6d_64 loop (kernels, auto K, launches {counts}): " + json.dumps(kern),
          flush=True)
    print_by_width("quad6d_64 loop", launches_by_width(
        lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS), MPC_STEPS, path))
    pinned, counts = run_counted(
        lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS, K=16))
    require(counts, path, "the quad6d_64 loop at K=16", solves=pinned["steps"])
    launches["per MPC step (64 Quad6D, K=16)"] = {
        k: counts[k] / pinned["steps"] for k in path}
    print(f"quad6d_64 loop (kernels, K=16, launches {counts}): " + json.dumps(pinned),
          flush=True)
    twin, counts = run_counted(lambda: rhc_run(fleet, cost, x0, "torch", 2, K=16))
    no_sweep_kernel(counts)
    print("quad6d_64 loop (torch twins, K=16, 2 steps): " + json.dumps(twin), flush=True)
    # ROADMAP C2: the same loop in float64 on the kernels.  If it iterates
    # materially more (a third more iterations a step), float32 stops on
    # noise: its J is ~1e6 and a float32 accept resolves 1e-1.
    fleet64, cost64, x064 = quad_problem(dtt.QUAD_6D, 64, 0.85, torch.float64, dev)
    f64, counts = run_counted(
        lambda: rhc_run(fleet64, cost64, x064, "cuda", MPC_STEPS, dtype=np.float64))
    require(counts, path, "the quad6d_64 loop in float64", solves=f64["steps"])
    if max(f64["K"]) <= 16:
        fail("the quad6d_64 loop did not reach K=32 in float64")
    noise = f64["mean_iters"] > 4 / 3 * kern["mean_iters"]
    print("quad6d_64 loop float32 vs float64 (kernels, auto K): " + json.dumps({
        "noise_limited": bool(noise), "float32": kern, "float64": f64}), flush=True)


def quad12d_solve(dev):
    """Phase 4c: one cold quad12d_64_k8 decomposed solve (bench.py:335-347),
    float32 on the kernels; then (ROADMAP C1) in float64 and in float32 with
    ``mu_floor``, printed beside it with the bar (mean iterations >= 5 and
    converged fraction > 0.5) each meets."""
    import dpilqr_tpu_torch as dtt

    def solve(dtype, mu_floor=False):
        fleet, cost, x0 = quad_problem(dtt.QUAD_12D, 64, 0.85, dtype, dev)
        X0 = torch.as_tensor(x0, dtype=dtype, device=dev)[None]
        U0 = torch.zeros((HORIZON, 64, 4), dtype=dtype, device=dev)
        cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend="cuda",
                               mu_floor=mu_floor)
        t0 = time.perf_counter()
        r = dtt.solve_distributed(fleet, cost, X0.expand(HORIZON + 1, -1, -1), U0,
                                  RADIUS, K=8, config=cfg)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    def summary(res, ms):
        iters = res.iters.float().mean().item()
        conv = res.converged.float().mean().item()
        return {"ms": ms, "mean_iters": iters, "converged_frac": conv,
                "J": float(res.J), "truncated": bool(res.truncated),
                "meets_bar": iters >= 5 and conv > 0.5}

    (res, ms), counts = run_counted(lambda: solve(torch.float32))
    require(counts, ("backward_batched_wide", "forward_batched", "forward_sweep"),
            "the quad12d_64_k8 solve")
    out = {"float32": summary(res, ms)}
    if not np.isfinite(out["float32"]["J"]) or bool(res.truncated):
        fail("quad12d_64_k8: non-finite J or truncated")
    if out["float32"]["mean_iters"] <= 1.0:
        fail(f"quad12d_64_k8: mean iterations {out['float32']['mean_iters']} <= 1, "
             "not a solve")
    out["float64"] = summary(*solve(torch.float64))
    out["float32 mu_floor"] = summary(*solve(torch.float32, mu_floor=True))
    print("quad12d_64_k8 cold solve (kernels): " + json.dumps(out), flush=True)


# Kernels of torch's own that one centralized iteration may launch besides
# K5 and K4: the accept step's elementwise, reduction and indexing work.
ACCEPT_KERNELS = ("elementwise", "reduce", "index", "argmax", "copy", "where",
                  "fill", "compare", "unrolled")


def iteration_kernels(dev):
    """The CUDA kernels of one centralized iteration (``make_iteration_fn``
    on the 10-agent problem, float32), counted by ``torch.profiler``: fails
    unless K5 and K4 run once each and everything else is the accept step's
    elementwise work (no prep: no matmul, einsum or Jacobian kernels)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import ilqr

    fleet, cost, x0 = centralized_inputs(torch.float32, dev)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-9, sweep_backend="cuda")
    iterate = ilqr.make_iteration_fn(fleet, cfg, "cuda")
    U0 = torch.zeros((HORIZON, 10, 2), dtype=torch.float32, device=dev)
    c = ilqr.init_carry(fleet, cfg, cost, x0, U0, "cuda")
    c = iterate(cost, c)  # warm-up: the alphas, the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iterate(cost, c)
        torch.cuda.synchronize()
    names = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
        and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    k5 = sum(n for k, n in names.items() if "backward_sweep_kernel" in k)
    k4 = sum(n for k, n in names.items() if "forward_sweep_kernel" in k)
    other = {k: n for k, n in names.items()
             if "backward_sweep_kernel" not in k and "forward_sweep_kernel" not in k}
    foreign = {k: n for k, n in other.items()
               if not any(w in k.lower() for w in ACCEPT_KERNELS)}
    out = {"kernels": sum(names.values()), "K5": k5, "K4": k4,
           "accept_step": sum(other.values()), "other": foreign}
    print("one centralized iteration, CUDA kernels (torch.profiler): " + json.dumps(out),
          flush=True)
    if not names:
        fail("torch.profiler saw no CUDA kernel in a centralized iteration")
    if k5 != 1 or k4 != 1 or foreign:
        fail("a centralized iteration runs more than K5, K4 and the accept step")


def centralized_paths(dev, launches):
    """Phase 4d: ilqr_solve (kernels vs twins, float32 and float64), the
    CUDA kernels of one iteration, and the centralized loop.  The float32
    solve at tol=1e-9 is no quality datum: the problem amplifies one
    rounding by about 1e6 (ROADMAP C3), so its iterations and J move with the
    order of the kernels' sums; float64 is printed beside it."""
    import dpilqr_tpu_torch as dtt

    out = {}
    for dtype in (torch.float32, torch.float64):
        fleet, cost, x0 = centralized_inputs(dtype, dev)
        x0_t = torch.as_tensor(x0, dtype=dtype, device=dev)
        for backend in ("cuda", "torch"):
            cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-9, sweep_backend=backend)
            solve = dtt.make_solver(fleet, HORIZON, cfg)
            U0 = torch.zeros((HORIZON, 10, 2), dtype=dtype, device=dev)
            solve(cost, x0_t, U0)  # warm-up

            def run(solve=solve, U0=U0, x0_t=x0_t, cost=cost):
                t0 = time.perf_counter()
                r = solve(cost, x0_t, U0)
                torch.cuda.synchronize()
                return r, (time.perf_counter() - t0) * 1e3

            (res, ms), counts = run_counted(run)
            key = f"{backend} {str(dtype)[6:]}"
            out[key] = {"ms": ms, "iters": int(res.iters),
                        "converged": bool(res.converged),
                        "failed_line_search": bool(res.failed_line_search),
                        "J": float(res.J), "quality_datum": dtype == torch.float64}
            if not np.isfinite(out[key]["J"]):
                fail(f"ilqr_solve ({key}): non-finite J")
            if backend == "cuda" and dtype == torch.float32:
                require(counts, ("backward_sweep", "forward_sweep"), "ilqr_solve")
                launches["backward_sweep"] = counts["backward_sweep"]
                launches["forward_sweep"] += counts["forward_sweep"]
                launches[f"per centralized solve (10 unicycles, {int(res.iters)} "
                         "iterations)"] = {
                    k: counts[k] for k in ("backward_sweep", "forward_sweep")}
            elif backend == "torch" and any(counts.values()):
                fail("the torch backend launched a kernel")
            print(f"ilqr_solve 10 agents ({key}): " + json.dumps(out[key]), flush=True)
    iteration_kernels(dev)
    fleet, cost, x0 = centralized_inputs(torch.float32, dev)
    kern, counts = run_counted(
        lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS, centralized=True))
    require(counts, ("backward_sweep", "forward_sweep"), "solve_rhc(centralized=True)")
    for k in ("backward_sweep", "forward_sweep"):
        launches[k] += counts[k]
    launches["per MPC step (10 unicycles, centralized)"] = {
        k: counts[k] / kern["steps"] for k in ("backward_sweep", "forward_sweep")}
    print(f"centralized loop (kernels, launches {counts}): " + json.dumps(kern), flush=True)


def same_solve(tag, a, b, names=("cuda", "torch")):
    """Fail unless two float64 solves took the same iterations and
    converged flags and agree on J (rtol 1e-9) and the trajectory."""
    print(f"f64 parity {tag}: iters {names[0]} {a.iters.tolist()} "
          f"{names[1]} {b.iters.tolist()}")
    if not torch.equal(a.iters, b.iters) or not torch.equal(a.converged, b.converged):
        fail(f"float64 {tag}: iteration counts or converged flags differ")
    dJ = abs(float(a.J) - float(b.J)) / abs(float(b.J))
    dX = float((a.X - b.X).abs().max())
    print(f"f64 parity {tag}: J {float(a.J)!r} vs {float(b.J)!r} (rel {dJ:.3e}), "
          f"max|dX| {dX:.3e}", flush=True)
    if not (dJ <= 1e-9 and dX <= 1e-8):
        fail(f"float64 {tag}: J or X differ beyond rtol 1e-9 / atol 1e-8")


def solve_parity(dev):
    """Phase 5: float64 solves, kernels vs twins."""
    import dpilqr_tpu_torch as dtt

    from dpilqr_tpu_torch.ops.ilqr import _rollout_batched_cost

    def distributed(fleet, cost, x0, N, seed, u_trim=0.0):
        rng = np.random.default_rng(seed)
        X = torch.as_tensor(x0, device=dev)[None]
        U = torch.as_tensor((u_trim + rng.uniform(size=(N, fleet.n_agents, fleet.nu_p))
                             * 0.01) * fleet.control_mask, device=dev)
        res = {b: dtt.solve_distributed(
            fleet, cost, X, U, RADIUS,
            config=dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend=b))
            for b in ("cuda", "torch")}
        # The stitched J comes from K4 under either backend; the plain
        # version sums time-batched, K4 step by step: 1e-12 relative.
        J_plain = float(_rollout_batched_cost(fleet.step, cost, X[0], res["cuda"].U)[1])
        dJ = abs(float(res["cuda"].J) - J_plain) / abs(J_plain)
        print(f"f64 stitched J: K4 {float(res['cuda'].J)!r} vs plain {J_plain!r} "
              f"(rel {dJ:.3e})")
        if not dJ <= 1e-12:
            fail("float64: the stitched J differs from its plain version beyond 1e-12")
        return res

    # Spacing 1.0 keeps the solve well conditioned (at 0.75 a 1e-14
    # warm-start perturbation already moves X by 2e-8), while neighborhoods
    # of up to 4 agents still couple.
    fleet, cost, x0 = unicycle_problem(16, 1.0, torch.float64, dev)
    r = distributed(fleet, cost, x0, 20, 3)
    same_solve("narrow decomposed (n=16, K=4)", r["cuda"], r["torch"])
    # A Quad6D swarm whose axis neighbours couple: neighbourhoods of up to
    # 7 agents, auto K = 8, nxf 48 (the wide kernel).  The warm start
    # hovers: from a free fall a 1e-14 perturbation of U moves the twin's
    # own X by 4e-5, from hover by 2e-11.
    fleet, cost, x0 = quad_problem(dtt.QUAD_6D, 27, 0.85, torch.float64, dev)
    r = distributed(fleet, cost, x0, 20, 4, u_trim=np.array([9.80665, 0, 0]))
    if int(r["cuda"].sizes.max()) <= 4:
        fail("the wide parity scenario does not reach K=8")
    same_solve("wide decomposed (Quad6D n=27, K=8)", r["cuda"], r["torch"])
    # The centralized problem of phase 4d is ill conditioned in float64 (a
    # 1e-14 perturbation of x0 moves its X by 2e-6); 10 unicycles on the
    # swap grid at spacing 1.0 couple through proximity and move by 5e-14.
    fleet, cost, x0 = unicycle_problem(10, 1.0, torch.float64, dev)
    U0 = torch.as_tensor(np.random.default_rng(3).uniform(size=(HORIZON, 10, 2)) * 0.01,
                         device=dev)
    res = {b: dtt.ilqr_solve(fleet, cost, torch.as_tensor(x0, device=dev), U0=U0,
                             config=dtt.SolverConfig(n_lqr_iter=15, tol=1e-3,
                                                     sweep_backend=b))
           for b in ("cuda", "torch")}
    same_solve("ilqr_solve (n=10)", res["cuda"], res["torch"])


def probe_checks(checks, dev):
    """Phase 6a: K6-K8 against their plain versions, at the shapes
    ``sol_report`` launches them at; returns the plain versions' times."""
    from dpilqr_tpu_torch.utils import sol
    from dpilqr_tpu_torch.utils.profiling import cuda_min_ms

    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.uniform(0.5, 1.5, sol.PROBE_SHAPE).astype(np.float32),
                        device=dev)
    # A fused multiply-add rounds once, the plain version's mul and add
    # twice; at 8 iterations (32 steps a chain) they stay within 1e-5, at the
    # timed 2048 they drift apart.  sinf against torch.sin differs by at most
    # a few ulp a step and the chains contract, so K8 is also held at the
    # timed iteration count.
    tol = {"out": 1e-5}
    checks.compare("probe_fma", "K6 iters=8", ("out",), (sol.probe_fma_cuda(x, 8),),
                   (sol.probe_fma_torch(x, 8),), tol)
    for iters in (3, sol.SIN_ITERS):
        checks.compare("probe_sin", f"K8 iters={iters}", ("out",),
                       (sol.probe_sin_cuda(x, iters),), (sol.probe_sin_torch(x, iters),),
                       tol)
    # 37 slabs: the unrolled part and the remainder of the slab loop; then
    # the timed buffer's shape (sums of 256 normals in another order).
    T = sol.HBM_MB * 1024 * 1024 // (512 * 512 * 4)
    for slabs in (37, T):
        x3 = torch.as_tensor(rng.standard_normal((slabs, 512, 512), dtype=np.float32),
                             device=dev)
        checks.compare("probe_hbm", f"K7 T={slabs}", ("out",), (sol.probe_hbm_cuda(x3),),
                       (sol.probe_hbm_torch(x3),), tol)
        del x3

    # The plain versions are tens of thousands of small launches: one run.
    ones = torch.ones(sol.PROBE_SHAPE, dtype=torch.float32, device=dev)
    sin_in = torch.full(sol.PROBE_SHAPE, 0.7, dtype=torch.float32, device=dev)
    return {"probe_fma": cuda_min_ms(lambda: sol.probe_fma_torch(ones, sol.FMA_ITERS), k=1),
            "probe_sin": cuda_min_ms(lambda: sol.probe_sin_torch(sin_in, sol.SIN_ITERS), k=1)}


def sol_phase(checks, results, probe_plain_ms, dev, launches):
    """Phase 6b: the accounting's main path, ``sol_report``; the probes'
    rates and times are the report's own."""
    from dpilqr_tpu_torch.utils import sol

    rep, counts = run_counted(lambda: sol.sol_report(dev))
    # The report times K1-K8; the accept kernel is timed in phase 11a.
    require(counts, [k for k in KERNELS if k != "accept_batched"], "sol_report")
    launches.update({k: counts[k] for k in ("probe_fma", "probe_hbm", "probe_sin")})
    print(f"sol_report: allow_tf32={rep['allow_tf32']}, ceilings "
          + json.dumps(rep["ceilings"]))
    ceil, probes = rep["ceilings"], rep["probes"]
    # The plain version of K7 is the library call itself.
    plain_ms = dict(probe_plain_ms, probe_hbm=probes["hbm_library_ms"])
    checks.library_ms["probe_hbm"] = probes["hbm_library_ms"]
    for label, key in (("K6", "probe_fma"), ("K7", "probe_hbm"), ("K8", "probe_sin")):
        results[label] = (probes[key].ms, plain_ms[key])
        checks.shapes[label] = probes[key].work
    fma_share = ceil["fma_gflop_s"] * 1e9 / sol.PUBLISHED_FP32_FLOPS
    hbm_share = ceil["hbm_gb_s"] * 1e9 / sol.PUBLISHED_HBM_BYTES_S
    sin_share = ceil["sin_gops_s"] / (ceil["fma_gflop_s"] / 2)
    print(f"K6 probe_fma: {probes['probe_fma'].ms:.4f} ms, {ceil['fma_gflop_s']:.1f} "
          f"GFLOP/s float32 = {fma_share:.3f} of the published 67 TFLOP/s; plain "
          f"version {plain_ms['probe_fma']:.3f} ms")
    print(f"K7 probe_hbm: {probes['probe_hbm'].ms:.4f} ms, {ceil['hbm_gb_s']:.1f} GB/s = "
          f"{hbm_share:.3f} of the published 3.35 TB/s; x.sum(0): "
          f"{probes['hbm_library_ms']:.4f} ms, {ceil['hbm_library_gb_s']:.1f} GB/s")
    sass_ms = sol.probe_sin_sass_bound_s(sol.PROBE_SHAPE[0] * sol.PROBE_SHAPE[1],
                                         sol.SIN_ITERS) * 1e3
    print(f"K8 probe_sin: {probes['probe_sin'].ms:.4f} ms, {ceil['sin_gops_s']:.2f} "
          f"G sinf/s = {sin_share:.4f} of the measured FMA instruction rate; bound "
          f"by its SASS ({sol.SIN_LOOP_SASS / 16} instructions a sine) {sass_ms:.5f} ms "
          f"(share {sass_ms / probes['probe_sin'].ms:.4f}); plain version "
          f"{plain_ms['probe_sin']:.3f} ms", flush=True)
    if fma_share > PEAK_OVERSHOOT:
        fail("K6 reads over 105% of the published float32 peak: a miscount or a folded loop")
    if hbm_share > PEAK_OVERSHOOT:
        fail("K7 reads over 105% of the published HBM bandwidth: reads served from cache?")
    if sin_share > 1:
        fail("K8: more sines than FMA instructions per second: a folded loop")
    for tag, r in rep["kernels"].items():
        shape = " ".join(f"{k}={v}" for k, v in r["shape"].items())
        print(f"sol {tag} {r['kernel']} {r['model']} {shape}: {r['launch_ms']:.4f} ms "
              f"a launch (torch prep {r['prep_ms']:.4f} ms apart), "
              f"{r['gflops']:.6f} GFLOP, {r['gbytes'] * 1e3:.4f} MB"
              + (f", {r['trig_gops'] * 1e3:.4f} M sin/cos/tan" if "trig_gops" in r else "")
              + f"; bound by measured ceilings {r['sol_s'] * 1e3:.5f} ms ({r['binding_limit']}"
              f", share {r['sol_frac']:.5f}); by published peaks "
              f"{r['bound_published_s'] * 1e3:.5f} ms ({r['bound_published_by']}, share "
              f"{r['published_frac']:.5f})")
        if not r["outputs_finite"]:
            fail(f"sol_report: {tag} gave non-finite outputs")
        if not (0 < r["sol_frac"] <= PEAK_OVERSHOOT
                and 0 < r["published_frac"] <= PEAK_OVERSHOOT):
            fail(f"sol_report: {tag}'s share of its bound is outside (0, 1.05]")
    ps = rep["pscan"]
    print("sol pscan " + json.dumps(ps))
    # Float32 over N = 200: the scan's 400 combines and the sequential
    # sweep's 200 steps round differently (3e-3 on the CPU at this problem).
    if not ps["max_rel_err_vs_sequential"] <= 5e-2:
        fail("the associative scan disagrees with the sequential sweep (float32, rel 5e-2)")
    if not 0 < ps["pscan_sol_frac_fair"] <= PEAK_OVERSHOOT:
        fail("pscan's share of the batched-matmul ceiling is outside (0, 1.05]")
    for path, per in launches.items():
        if isinstance(per, dict):
            print(f"launches {path}: " + json.dumps(per))
    print(f"launches per sol_report: {json.dumps(counts)}", flush=True)


def deadline_phase(dev):
    """Phase 6c: the solves under ``t_kill = dt``."""
    import dpilqr_tpu_torch as dtt

    fleet, cost, x0 = unicycle_problem(N_AGENTS, 1.25, torch.float32, dev)
    kern, counts = run_counted(
        lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS, t_kill=DT))
    require(counts, ("backward_batched", "forward_batched", "forward_sweep"),
            "the deadline main path", solves=kern["steps"])
    sync = host_sync_us(dev)
    # One sync an iteration (the active count) and one a step (the loop's
    # scalars): the share of a step spent waiting on those fetches.
    kern["host_sync_us"] = sync
    kern["host_sync_share_of_step"] = (
        (kern["mean_iters"] + 1) * sync * 1e-3 / kern["ms_per_step"])
    print(f"deadline main path (kernels, t_kill={DT}, launches {counts}): "
          + json.dumps(kern), flush=True)

    fleet, cost, x0 = centralized_inputs(torch.float32, dev)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-9, sweep_backend="cuda")

    def solve(t_kill=DT):
        t0 = time.perf_counter()
        r = dtt.ilqr_solve_steppable(fleet, cost, x0.astype(np.float32), N=HORIZON,
                                     config=cfg, t_kill=t_kill)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    solve(t_kill=None)  # warm-up: the first solve of a shape pays torch's set-up
    (res, ms), counts = run_counted(solve)
    require(counts, ("backward_sweep", "forward_sweep"), "ilqr_solve_steppable")
    if not res.X.is_cuda:
        fail("ilqr_solve_steppable on numpy input did not run on the card")
    out = {"ms": ms, "iters": int(res.iters), "converged": bool(res.converged),
           "J": float(res.J)}
    print(f"ilqr_solve_steppable 10 agents (kernels, t_kill={DT}, launches {counts}): "
          + json.dumps(out), flush=True)
    if not np.isfinite(out["J"]) or out["iters"] < 1:
        fail("ilqr_solve_steppable: non-finite J or no iteration")

    # Float64: without a deadline the deadline solve is solve_distributed.
    fleet, cost, x0 = unicycle_problem(16, 1.0, torch.float64, dev)
    rng = np.random.default_rng(3)
    X = torch.as_tensor(x0, device=dev)[None]
    U = torch.as_tensor(rng.uniform(size=(20, 16, 2)) * 0.01, device=dev)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend="cuda")
    plain = dtt.solve_distributed(fleet, cost, X, U, RADIUS, config=cfg)
    stepped = dtt.solve_distributed_steppable(fleet, cost, X, U, RADIUS, config=cfg,
                                              t_kill=None)
    same_solve("solve_distributed_steppable(t_kill=None) vs solve_distributed",
               stepped, plain, names=("steppable", "plain"))
    if not (torch.equal(stepped.X, plain.X) and torch.equal(stepped.U, plain.U)):
        fail("float64: the deadline solve without a deadline is not solve_distributed")
    cold = dtt.solve_distributed_steppable(fleet, cost, X, U, RADIUS, config=cfg,
                                           t_kill=0.0)
    if int(cold.iters.sum()) != 0 or not torch.equal(cold.U, U):
        fail("t_kill=0 did not return the warm start after zero iterations")


def facade_problem(n, spacing, dev, seed=0):
    """The reference-shaped problem of ``n`` Unicycle4D agents on the swap
    grid (``api``: models, ``ReferenceCost``s with Q = I, R = I, Qf = 1e3 I,
    a ``ProximityCost`` of radius 0.5), with the flat start and the same
    problem as the tensor API takes it: ``(problem, x0 flat, fleet, cost,
    x0 block)``."""
    from dpilqr_tpu_torch import api

    api._reset_ids()
    x0, xf = swap_scenario(n, spacing, seed)
    dyn = api.MultiDynamicalModel([api.UnicycleDynamics4D(DT, device=dev)
                                   for _ in range(n)])
    rcs = [api.ReferenceCost(xf[i], np.eye(4), np.eye(2), 1e3 * np.eye(4))
           for i in range(n)]
    prob = api.ilqrProblem(dyn, api.GameCost(rcs, api.ProximityCost([4] * n, RADIUS)))
    fleet = dyn._fleet
    return prob, x0.reshape(-1), fleet, prob._as_game().to_array_spec(fleet, dev), x0


def bit_equal(tag, got, want):
    """Fail unless the facade's arrays have the bits of the tensor API's."""
    for name, a, b in zip(("X", "U", "J"), got, want):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            d = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
            fail(f"{tag}: the facade's {name} differs from the tensor API's (max {d:.3e})")
    print(f"{tag}: X, U and J bit-equal to the tensor API", flush=True)


def facade_phase(checks, results, dev, launches):
    """Phase 7: the facade (``api``), Monte-Carlo trials and the model guard."""
    import importlib.util

    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch import api
    from dpilqr_tpu_torch.models.specs import ModelSpec
    from dpilqr_tpu_torch.ops import batched as bt
    from dpilqr_tpu_torch.ops import cuda_build
    from dpilqr_tpu_torch.parallel.mesh import stack_costs

    print("optional modules on this machine: " + json.dumps(
        {m: importlib.util.find_spec(m) is not None
         for m in ("sympy", "matplotlib", "networkx")}), flush=True)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3)
    path = ("backward_batched", "forward_batched", "forward_sweep")

    # a. The facade's decomposed MPC loop, 100 agents, float64.
    prob, x0, fleet, cost, x0b = facade_problem(N_AGENTS, 1.25, dev)
    steps = []
    kw = dict(radius=RADIUS, centralized=False, J_converge=1e-3, t_diverge=4 * DT,
              config=cfg)

    def run_facade():
        steps.clear()
        t0 = time.perf_counter()
        out = api.solve_rhc(prob, x0, HORIZON, rng=np.random.default_rng(0),
                            log_fn=steps.append, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run_facade()  # warm-up
    (got, wall), counts = run_counted(run_facade)
    require(counts, path, "the facade's decomposed loop", solves=len(steps))
    for k in path:
        launches[k] += counts[k]
    if len(steps) != MPC_STEPS or not np.isfinite(got[0]).all():
        fail(f"the facade's decomposed loop ran {len(steps)} steps or diverged")
    res = dtt.solve_rhc(fleet, cost, x0b, HORIZON, rng=np.random.default_rng(0),
                        device=dev, **kw)
    bit_equal("facade solve_rhc(centralized=False)", got,
              (fleet.unpad_states(res.X), fleet.unpad_controls(res.U), res.J))
    iters = np.concatenate([np.asarray(s.iters) for s in steps])
    conv = np.concatenate([np.asarray(s.converged) for s in steps])
    print(f"facade decomposed loop ({N_AGENTS} Unicycle4D, float64, launches "
          f"{ {k: counts[k] for k in path} }): " + json.dumps(
              {"ms_per_step": wall / len(steps) * 1e3, "steps": len(steps),
               "mean_iters": float(iters.mean()), "converged_frac": float(conv.mean()),
               "J_executed": got[2]}), flush=True)

    # b. The facade's centralized solve and controller, phase 5's problem.
    prob, x0, fleet, cost, x0b = facade_problem(10, 1.0, dev)
    U0 = np.random.default_rng(3).uniform(size=(HORIZON, 20)) * 0.01
    solver = api.ilqrSolver(prob, HORIZON)
    got, counts = run_counted(
        lambda: solver.solve(x0, U0, n_lqr_iter=15, tol=1e-3, verbose=False))
    require(counts, ("backward_sweep", "forward_sweep"), "the facade's ilqrSolver")
    for k in ("backward_sweep", "forward_sweep"):
        launches[k] += counts[k]

    def tensor_solve(x, U):
        r = dtt.ilqr_solve(fleet, cost, torch.as_tensor(fleet.pad_states(x), device=dev),
                           U0=torch.as_tensor(fleet.pad_controls(U), device=dev),
                           config=cfg)
        return fleet.unpad_states(r.X.cpu()), fleet.unpad_controls(r.U.cpu()), float(r.J)

    bit_equal("facade ilqrSolver.solve (10 agents)", got, tensor_solve(x0, U0))
    rhc = api.RecedingHorizonController(x0, solver, 1)
    x, U = x0, U0
    for i, (Xs, Us, J) in enumerate(rhc.solve(U0, J_converge=0.0, n_lqr_iter=15,
                                              tol=1e-3, verbose=False)):
        Xw, Uw, Jw = tensor_solve(x, U)
        bit_equal(f"facade RecedingHorizonController step {i}", (Xs, Us, J),
                  (Xw[:1], Uw[:1], Jw))
        x, U = Xw[1], np.vstack([Uw[1:], np.zeros((1, 20))])
        if i == 2:
            break
    print(f"facade centralized (10 agents, float64, launches "
          f"{ {k: counts[k] for k in ('backward_sweep', 'forward_sweep')} }): "
          f"J {got[2]!r}", flush=True)

    # c. Monte-Carlo trials: 8 x 100 Unicycle4D at K = 8, one batch of 800.
    T, K = 8, 8
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, N_AGENTS, DT)
    mesh = dtt.make_mesh([dev])
    for dtype in (torch.float64, torch.float32):
        npd = np.float64 if dtype == torch.float64 else np.float32
        costs, X_T, U_T = [], [], []
        for t in range(T):
            x0_t, xf_t = swap_scenario(N_AGENTS, 1.25, seed=t)
            costs.append(problem(fleet, x0_t, xf_t, dtype, dev)[0])
            X_T.append(x0_t[None])
            U_T.append(np.random.default_rng(t).uniform(size=(HORIZON, N_AGENTS, 2))
                       * 0.01)
        X_T, U_T = np.stack(X_T).astype(npd), np.stack(U_T).astype(npd)

        # K1 at the trials' batch width: each trial's gathered batch at K,
        # joined into one of T * 100 subproblems, against its plain version.
        parts = [sweep_inputs(fleet, costs[t], X_T[t][0], K, dev, seed=t)[0]
                 for t in range(T)]
        big = (fleet, type(parts[0][1])(*(torch.cat(f) for f in zip(*(p[1] for p in parts)))),
               *(torch.cat([p[i] for p in parts]) for i in (2, 3, 4, 5)))
        tag = f"K1 trials S={batch_width(big)}"
        checks.compare("backward_batched", f"{tag} {str(dtype)[6:]}", ("Kg", "d"),
                       bt.backward_pass_batched_cuda(*big), plain_backward(big),
                       backward_tol(dtype))
        if dtype == torch.float32:
            results[tag] = (timed(lambda: bt.backward_pass_batched_cuda(*big), 10),
                            timed(lambda: plain_backward(big), 1))
            checks.shapes[tag] = work_shape("backward", fleet, K, batch_width(big))
            print_result(checks, results, tag)
        del parts, big

        def trials():
            t0 = time.perf_counter()
            r = dtt.solve_trials_sharded(fleet, stack_costs(costs), X_T, U_T, RADIUS,
                                         mesh, K, config=cfg)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        def sequential():
            t0 = time.perf_counter()
            out = [dtt.solve_distributed(fleet, costs[t], torch.as_tensor(X_T[t], device=dev),
                                         torch.as_tensor(U_T[t], device=dev), RADIUS, K=K,
                                         config=cfg) for t in range(T)]
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        trials()  # warm-up
        (res, wall), counts = run_counted(trials)
        require(counts, path, f"the trials batch ({str(dtype)[6:]})", solves=T)
        for k in path:
            launches[k] += counts[k]
        seq, wall_seq = sequential()
        tol = TOL[dtype]
        for t in (0, 3, 7):
            ref = seq[t]
            if dtype == torch.float64:
                if not (torch.equal(res.iters[t], ref.iters)
                        and torch.equal(res.converged[t], ref.converged)):
                    fail(f"trial {t} (float64): iterations or flags differ from its "
                         "own solve_distributed")
                rel, ab = rel_err(res.X[t], ref.X)
                print(f"trial {t} float64 X: rel err {rel:.3e} (abs {ab:.3e})")
                if not rel <= tol["X5"]:
                    fail(f"trial {t} (float64): X differs from its own solve_distributed")
            dJ = abs(float(res.J[t]) - float(ref.J)) / abs(float(ref.J))
            print(f"trial {t} {str(dtype)[6:]} J: {float(res.J[t])!r} vs "
                  f"{float(ref.J)!r} (rel {dJ:.3e}, tol {tol['J']:g})")
            if not dJ <= tol["J"]:
                fail(f"trial {t} ({str(dtype)[6:]}): J differs from its own "
                     "solve_distributed")
        by_width = launches_by_width(lambda: trials(), 1,
                                     ("backward_batched", "forward_batched"))
        at800 = {}
        for kernel, family in (("backward_batched", "backward"),
                               ("forward_batched", "forward")):
            for key, cell in by_width[kernel].items():
                if not key.startswith(f"S={T * N_AGENTS}"):
                    continue
                n_alpha = int(key.split("alphas=")[1]) if "alphas" in key else 0
                b_ms, by = bound_ms(dict(work_shape(family, fleet, K, T * N_AGENTS, n_alpha),
                                         dtype_bytes=dtype.itemsize))
                at800[f"{kernel} {key}"] = {
                    "launches": cell["launches_per_step"],
                    "ms_per_launch": cell["ms_per_launch"], "bound_ms": b_ms,
                    "bound_by": by, "share": b_ms / cell["ms_per_launch"]}
            if not any(k.startswith(kernel) for k in at800):
                fail(f"the trials batch never launched {kernel} at S={T * N_AGENTS}")
        print(f"trials {T} x {N_AGENTS} Unicycle4D K={K} {str(dtype)[6:]} (launches "
              f"{ {k: counts[k] for k in path} }): " + json.dumps(
                  {"wall_ms": wall * 1e3, "sequential_wall_ms": wall_seq * 1e3,
                   "mean_iters": float(res.iters.float().mean()),
                   "converged_frac": float(res.converged.float().mean()),
                   "J": res.J.tolist()}), flush=True)
        print_by_width(f"trials {str(dtype)[6:]}", by_width)
        print(f"trials {str(dtype)[6:]} at S={T * N_AGENTS}: " + json.dumps(at800),
              flush=True)

    # d. The guard: a custom model never reaches a kernel.
    def uni(x, u):
        return torch.stack([x[..., 2] * torch.cos(x[..., 3]),
                            x[..., 2] * torch.sin(x[..., 3]), u[..., 0], u[..., 1]], -1)

    custom = dtt.Fleet((ModelSpec("SmokeCustom", 1000, 4, 2, f=uni),) * 10, DT)
    cost, x0b = problem(custom, *swap_scenario(10, 1.0), torch.float64, dev)
    X = torch.as_tensor(x0b, device=dev)
    U = torch.zeros((HORIZON, 10, 2), dtype=torch.float64, device=dev)
    for name, call in (
            ("solve_distributed", lambda: dtt.solve_distributed(fleet=custom, cost=cost,
                                                                X=X[None], U=U,
                                                                radius=RADIUS)),
            ("ilqr_solve", lambda: dtt.ilqr_solve(custom, cost, X, U0=U))):
        def refused(call=call):
            try:
                call()
            except NotImplementedError as e:
                return str(e)
            return None

        msg, counts = run_counted(refused)
        if msg is None:
            fail(f"{name} ran a custom model on the card")
        if any(counts.values()):
            fail(f"{name} launched a kernel before refusing a custom model: {counts}")
        print(f"guard: {name} on a custom model raised before any launch: {msg}")
    cuda_build.reset_launch_counts()


def print_registers(tag, lib, source, kernel):
    """Print the registers and spills of ``kernel``'s instantiations, from
    the build's ``-Xptxas=-v`` report, and return them (None where the
    library was built before this run, without the report)."""
    import re

    from dpilqr_tpu_torch.ops import cuda_build

    if not (lib.parent / f"{source}.log").exists():
        print(f"{tag}: built before this run, no ptxas report", flush=True)
        return None
    report = cuda_build.ptxas_report(lib, source, kernel)
    if not report:
        fail(f"{tag}: no {kernel} entry in the ptxas report of {source}")
    rows = {}
    for name, (regs, st, ld) in sorted(report.items()):
        # The type and the integer template arguments (K2: NXC, TILES; K1:
        # NR, NCB, NXC, NXS, NUS, KS).
        m = re.search(r"kernelI([fd])((?:L[ib]\d+E)+)", name)
        key = (f"{'float' if m.group(1) == 'f' else 'double'} <"
               + ",".join(re.findall(r"\d+", m.group(2))) + ">") if m else name
        rows[key] = {"registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld}
    print(f"{tag} {kernel} registers: " + json.dumps(rows), flush=True)
    return rows


def custom_counts():
    """Launches from the custom-model library since the last reset."""
    from dpilqr_tpu_torch.ops import cuda_build

    return dict(cuda_build.custom_launch_counts)


def require_custom(counts, kernels, path):
    """Fail unless every launch of ``kernels`` in the run came from the
    custom-model library (and there was one)."""
    custom = custom_counts()
    for k in kernels:
        if counts[k] <= 0 or custom[k] != counts[k]:
            fail(f"{path}: {k} launched {counts[k]} times, {custom[k]} from the "
                 "custom-model library")


def bits_agree(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def custom_checks(checks, results, dev, UserBike):
    """Phase 8a: K1, K2, K3, K4 and K5 of the custom-model build on fleets
    of the user bicycle against their plain versions, each timed beside the
    same launch of the default build on ``Bike5D`` fleets of the same shape
    and the same inputs."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt
    from dpilqr_tpu_torch.ops import cuda_build, ilqr, sweeps

    bike = UserBike(DT).spec
    x0p, xfp = swap_scenario(N_AGENTS, 0.55)
    x10, xf10 = swap_scenario(10, 1.0)
    for dtype in (torch.float64, torch.float32):
        fl = {"custom bicycle": dtt.homogeneous_fleet(bike, N_AGENTS, DT),
              "Bike5D": dtt.homogeneous_fleet(dtt.BIKE_5D, N_AGENTS, DT)}
        # K2 at the main path's shape (S = 100, K = 8, nxf 40), inputs made
        # once on the Bike5D fleet.
        cost, x0 = problem(fl["Bike5D"], x0p, xfp, dtype, dev)
        args, sub_cost, mids, carry = sweep_inputs(fl["Bike5D"], cost, x0, 8, dev)
        Kg, d = plain_backward(args)
        # K1 at K = 6 (nxf 30) and K3 at K = 8 (nxf 40), the widths the
        # bicycles' loop runs at, on the same batches of the two fleets.
        for K_, kernel, fn, family in (
                (6, "backward_batched", bt.backward_pass_batched_cuda, "backward"),
                (8, "backward_batched_wide", bt.backward_pass_batched_wide_cuda,
                 "backward_wide")):
            base = sweep_inputs(fl["Bike5D"], cost, x0, K_, dev)[0]
            outs = []
            for name, fleet in fl.items():
                bargs = (fleet, *base[1:])
                label = f"{'K1' if K_ == 6 else 'K3'} {name} K={K_}"
                outs.append(fn(*bargs))
                checks.compare(kernel, f"{label} {str(dtype)[6:]}", ("Kg", "d"),
                               outs[-1], plain_backward(bargs), backward_tol(dtype))
                if dtype == torch.float32:
                    results[label] = (timed(lambda: fn(*bargs), 10),
                                      timed(lambda: plain_backward(bargs), 2))
                    checks.shapes[label] = work_shape(family, fleet, K_,
                                                      batch_width(bargs), model="Bike5D")
                    print_result(checks, results, label)
            print(f"{'K1' if K_ == 6 else 'K3'} K={K_} {str(dtype)[6:]}: custom bicycle "
                  f"and Bike5D bit-equal: {bits_agree(*outs)}", flush=True)
        for name, fleet in fl.items():
            forward_checks(checks, results, f"{name} K=8", fleet, sub_cost, mids, carry,
                           Kg, d, dtype, dev, model="Bike5D")
        alphas = dtt.ops.line_search_alphas(2, dtype, dev)
        outs = [bt.forward_pass_batched_cuda(f, sub_cost, mids, carry.X, carry.U, Kg, d,
                                             alphas) for f in fl.values()]
        print(f"K2 {str(dtype)[6:]}: custom bicycle and Bike5D bit-equal: "
              f"{bits_agree(*outs)}", flush=True)

        # K4 without gains (the plain rollout) at 100 agents.
        x0_t = torch.as_tensor(x0, dtype=dtype, device=dev)
        U = torch.as_tensor(np.random.default_rng(5).uniform(size=(HORIZON, N_AGENTS, 2))
                            * 0.01, dtype=dtype, device=dev)
        outs = []
        for name, fleet in fl.items():
            got = sweeps.rollout_cuda(fleet, cost, x0_t, U)
            checks.compare("forward_sweep", f"K4 rollout {name} 100 {str(dtype)[6:]}",
                           ("X5", "J"), got, ilqr._rollout_fn(fleet.step, cost, x0_t, U),
                           TOL[dtype])
            outs.append(got)
            if dtype == torch.float32:
                label = f"K4 rollout {name} 100, the launch alone"
                with cuda_build.timed_launches() as record:
                    for _ in range(10):
                        sweeps.rollout_cuda(fleet, cost, x0_t, U)
                results[label] = (min(cuda_build.launch_ms(record, "forward_sweep")), None)
                checks.shapes[label] = work_shape("rollout_sweep", fleet, N_AGENTS, 1, 1,
                                                  "Bike5D")
        print(f"K4 rollout {str(dtype)[6:]}: custom bicycle and Bike5D bit-equal: "
              f"{bits_agree(*outs)}", flush=True)

        # K5 and K4 with gains at the centralized shape: 10 bicycles.
        f10 = {"custom bicycle": dtt.homogeneous_fleet(bike, 10, DT),
               "Bike5D": dtt.homogeneous_fleet(dtt.BIKE_5D, 10, DT)}
        cost10, x10_0 = problem(f10["Bike5D"], x10, xf10, dtype, dev)
        # A warm start of 0.01 as phase 3c's rollouts: at 0.1 the bicycles'
        # closed loop amplifies float32 rounding to 2e-4 (on Bike5D alike).
        U10 = torch.as_tensor(np.random.default_rng(2).uniform(size=(HORIZON, 10, 2)) * 0.01,
                              dtype=dtype, device=dev)
        X10 = ilqr._rollout_fn(f10["Bike5D"].step, cost10,
                               torch.as_tensor(x10_0, dtype=dtype, device=dev), U10)[0]
        mu = torch.tensor(1.0, dtype=dtype, device=dev)
        K_t, d_t = ilqr._backward_pass(f10["Bike5D"].linearize, cost10, X10, U10, mu)
        alphas = dtt.ops.line_search_alphas(10, dtype, dev)
        k5, k4 = [], []
        for name, fleet in f10.items():
            bw = (fleet, cost10, X10, U10, mu)
            got = sweeps.backward_pass_cuda(*bw)
            checks.compare("backward_sweep", f"K5 {name} 10 {str(dtype)[6:]}", ("Kg", "d"),
                           got, ilqr._backward_pass(fleet.linearize, cost10, X10, U10, mu),
                           TOL[dtype])
            k5.append(got)
            fw = (cost10, X10, U10, K_t, d_t, alphas)
            got = sweeps.forward_pass_cuda(fleet, *fw)
            checks.compare("forward_sweep", f"K4 {name} 10 alphas {str(dtype)[6:]}",
                           ("X5", "U5", "J"), got, ilqr._forward_pass(fleet.step, *fw),
                           TOL[dtype])
            k4.append(got)
            if dtype == torch.float32:
                with cuda_build.timed_launches() as record:
                    for _ in range(10):
                        sweeps.backward_pass_cuda(*bw)
                label = f"K5 {name} 10"
                results[label] = (
                    min(cuda_build.launch_ms(record, "backward_sweep")),
                    timed(lambda: ilqr._backward_pass(fleet.linearize, cost10, X10, U10,
                                                      mu), 3))
                checks.shapes[label] = dict(work_shape("backward_sweep", fleet, 10, 1,
                                                       model="Bike5D"))
                label = f"K4 {name} 10 alphas"
                results[label] = (
                    timed(lambda: sweeps.forward_pass_cuda(fleet, *fw), 20),
                    timed(lambda: ilqr._forward_pass(fleet.step, *fw), 3))
                checks.shapes[label] = work_shape("forward_sweep", fleet, 10, 1, 10, "Bike5D")
        print(f"K5 {str(dtype)[6:]}: custom bicycle and Bike5D bit-equal: "
              f"{bits_agree(k5[0], k5[1])}; K4 with gains: {bits_agree(k4[0], k4[1])}",
              flush=True)
    # Every launch of a custom fleet above came from the custom library.
    cuda_build.reset_launch_counts()
    sweeps.backward_pass_cuda(f10["custom bicycle"], cost10, X10, U10, mu)
    if custom_counts()["backward_sweep"] != 1:
        fail("K5 of a custom fleet did not launch from the custom-model library")
    cuda_build.reset_launch_counts()


def rhc_result(fleet, cost, x0, steps, dtype=np.float32):
    """``solve_rhc`` as ``rhc_run`` drives it, returning its result."""
    import dpilqr_tpu_torch as dtt

    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3)
    return dtt.solve_rhc(fleet, cost, x0.astype(dtype), HORIZON, radius=RADIUS,
                         centralized=False, step_size=1, J_converge=1e-3,
                         t_diverge=(steps - 1) * DT, config=cfg,
                         rng=np.random.default_rng(0), device=cost.xf.device)


def within(a, b, rel):
    return abs(a - b) <= rel * abs(b) + 1e-12


def custom_main_path(dev, launches, UserBike):
    """Phase 8b: the decomposed MPC loop of 100 user bicycles (one shared
    spec) at the main path's scenario, on the kernels, beside the same loop
    of ``Bike5D``."""
    import dpilqr_tpu_torch as dtt

    x0p, xfp = swap_scenario(N_AGENTS, 1.25)
    specs = {"custom bicycle": UserBike(DT).spec, "Bike5D": dtt.BIKE_5D}
    # K1 up to K = 6 slots (nxf 30), K3 past it (K = 8: nxf 40).
    path = ("backward_batched", "forward_batched", "forward_sweep")
    runs = {}
    for name, spec in specs.items():
        fleet = dtt.homogeneous_fleet(spec, N_AGENTS, DT)
        cost, x0 = problem(fleet, x0p, xfp, torch.float32, dev)
        rhc_run(fleet, cost, x0, "cuda", MPC_STEPS)  # warm-up
        runs[name], counts = run_counted(lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS))
        require(counts, path, f"the {name} loop", solves=runs[name]["steps"])
        if name == "custom bicycle":
            require_custom(counts, ("backward_batched", "forward_batched", "forward_sweep")
                           + (("backward_batched_wide",)
                              if counts["backward_batched_wide"] else ()),
                           "the custom loop")
            for k in (*path, "backward_batched_wide"):
                launches[k] += counts[k]
            print_by_width("custom bicycle loop", launches_by_width(
                lambda: rhc_run(fleet, cost, x0, "cuda", MPC_STEPS), MPC_STEPS,
                (*path, "backward_batched_wide")))
        elif any(custom_counts().values()):
            fail("the Bike5D loop launched the custom-model library")
        print(f"{name} loop ({N_AGENTS} agents, float32, launches {counts}): "
              + json.dumps(runs[name]), flush=True)
    c, b = runs["custom bicycle"], runs["Bike5D"]
    if c["K"] != b["K"]:
        fail(f"the custom loop's K {c['K']} differs from Bike5D's {b['K']}")
    for key in ("mean_iters", "converged_frac"):
        if not within(c[key], b[key], 0.02):
            fail(f"the custom loop's {key} {c[key]} is not within 2% of Bike5D's {b[key]}")
    print(f"custom bicycle loop: {c['ms_per_step']:.1f} ms a step, Bike5D "
          f"{b['ms_per_step']:.1f}; mean iterations {c['mean_iters']} / {b['mean_iters']}, "
          f"converged {c['converged_frac']} / {b['converged_frac']}", flush=True)

    res = {}
    for name, spec in specs.items():
        fleet = dtt.homogeneous_fleet(spec, N_AGENTS, DT)
        cost, x0 = problem(fleet, x0p, xfp, torch.float64, dev)
        res[name] = rhc_result(fleet, cost, x0, 2, np.float64)
    c, b = res["custom bicycle"], res["Bike5D"]
    it_c = [np.asarray(s.iters).tolist() for s in c.steps]
    it_b = [np.asarray(s.iters).tolist() for s in b.steps]
    cv_c = [np.asarray(s.converged).tolist() for s in c.steps]
    cv_b = [np.asarray(s.converged).tolist() for s in b.steps]
    if len(c.steps) != 2 or it_c != it_b or cv_c != cv_b:
        fail("float64: the custom loop's iterations or flags differ from Bike5D's")
    dX = float(np.abs(c.X - b.X).max()) / float(np.abs(b.X).max())
    print(f"custom bicycle loop float64, 2 steps: iterations and flags equal to "
          f"Bike5D's, X rel {dX:.3e}, bit-equal {np.array_equal(c.X, b.X)}", flush=True)
    if not dX <= 1e-9:
        fail("float64: the custom loop's X differs from Bike5D's beyond 1e-9")


def facade_bikes(make, n, device):
    """The facade problem of ``n`` bicycles (``make(device)`` each) on phase
    5's placement (the swap grid at spacing 1.0), Q = I, R = I, Qf = 1e3 I,
    radius 0.5; with the flat start and warm start."""
    from dpilqr_tpu_torch import api

    api._reset_ids()
    x0p, xfp = swap_scenario(n, 1.0)
    pad = np.zeros(3)
    dyn = api.MultiDynamicalModel([make(device) for _ in range(n)])
    rcs = [api.ReferenceCost(np.r_[xfp[i, :2], pad], np.eye(5), np.eye(2), 1e3 * np.eye(5))
           for i in range(n)]
    prob = api.ilqrProblem(dyn, api.GameCost(rcs, api.ProximityCost([5] * n, RADIUS)))
    x0 = np.concatenate([np.r_[x0p[i, :2], pad] for i in range(n)])
    U0 = np.random.default_rng(3).uniform(size=(HORIZON, 2 * n)) * 0.01
    return prob, x0, U0


def facade_solve(prob, x0, U0):
    """``ilqrSolver.solve`` at 15 iterations, tol 1e-3: ``(X, U, J,
    iterations)``, the iterations read from its verbose line."""
    import contextlib
    import io

    from dpilqr_tpu_torch import api

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        X, U, J = api.ilqrSolver(prob, HORIZON).solve(x0, U0, n_lqr_iter=15, tol=1e-3,
                                                     verbose=True)
    torch.cuda.synchronize()
    return X, U, J, int(buf.getvalue().split("/")[0])


def custom_centralized(dev, launches, UserBike):
    """Phase 8c: the facade's centralized solve and loop on 10
    ``SymbolicModel`` bicycles (10 instances, 10 model ids, one generated
    field): K5 and K4 from the custom-model library and nothing else."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch import api
    from dpilqr_tpu_torch.ops.costs import cast_cost

    def user(device):
        return UserBike(DT, device=device)

    prob, x0, U0 = facade_bikes(user, 10, dev)
    fleet = prob.dynamics._fleet
    if len(fleet.unique_specs) != 10:
        fail("the facade bicycles do not carry 10 model ids")
    kernels = ("backward_sweep", "forward_sweep")
    facade_solve(prob, x0, U0)  # warm-up
    (X, U, J, it), counts = run_counted(lambda: facade_solve(prob, x0, U0))
    require_custom(counts, kernels, "the facade's ilqrSolver on custom bicycles")
    if any(n for k, n in counts.items() if k not in kernels):
        fail(f"the custom centralized solve launched another kernel: {counts}")
    for k in kernels:
        launches[k] += counts[k]
    refs = {"BikeDynamics5D": facade_solve(*facade_bikes(
                lambda device: api.BikeDynamics5D(DT, device=device), 10, dev)),
            "twins (CPU)": facade_solve(*facade_bikes(user, 10, "cpu"))}
    for name, (_, _, J_r, it_r) in refs.items():
        dJ = abs(J - J_r) / abs(J_r)
        print(f"custom centralized float64: J {J!r} vs {name} {J_r!r} (rel {dJ:.3e}), "
              f"iterations {it} / {it_r}", flush=True)
        if it != it_r or not dJ <= 1e-9:
            fail(f"the custom centralized solve differs from {name}")
    print(f"custom centralized (10 facade bicycles, float64, launches "
          f"{ {k: counts[k] for k in kernels} }): J {J!r}, {it} iterations", flush=True)

    # Float32 through the tensor API on the same fleet and cost.
    cost32 = cast_cost(prob._as_game().to_array_spec(fleet, dev), torch.float32)
    x0b = torch.as_tensor(fleet.pad_states(x0), dtype=torch.float32, device=dev)
    U0b = torch.as_tensor(fleet.pad_controls(U0), dtype=torch.float32, device=dev)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3)
    r32, counts = run_counted(lambda: dtt.ilqr_solve(fleet, cost32, x0b, U0=U0b, config=cfg))
    require_custom(counts, kernels, "ilqr_solve float32 on custom bicycles")
    if not np.isfinite(float(r32.J)):
        fail("the custom centralized solve (float32) has a non-finite J")
    print(f"custom centralized float32: J {float(r32.J)!r} (float64 {J!r}), "
          f"{int(r32.iters)} iterations", flush=True)

    steps = []
    (Xr, Ur, Jr), counts = run_counted(lambda: api.solve_rhc(
        prob, x0, HORIZON, centralized=True, J_converge=1e-3, t_diverge=2 * DT,
        config=cfg, rng=np.random.default_rng(0), log_fn=steps.append))
    require_custom(counts, kernels, "the facade's solve_rhc(centralized=True)")
    if len(steps) != 3 or not np.isfinite(Xr).all() or not np.isfinite(Jr):
        fail(f"the custom centralized loop ran {len(steps)} steps or diverged")
    for k in kernels:
        launches[k] += counts[k]
    print(f"custom centralized loop (3 steps, launches "
          f"{ {k: counts[k] for k in kernels} }): J {Jr!r}", flush=True)


def custom_mixed(checks, dev, launches, UserBike):
    """Phase 8d: 30 user bicycles, 40 Unicycle4D and 30 Car3D in one
    decomposed solve (K=8, packed at spacing 0.55 so that pairs couple),
    float64.  The kernels' solve must have the bits of the same fleet with
    ``Bike5D`` in the bicycles' place, and one iteration's K3 and K2 (ids
    1000, 3 and 2 in one subproblem) must agree with their twins.  The whole
    solve is not held against the twins' solve: this packing amplifies a
    1e-13 change of the warm start into other iteration counts in the twins'
    own solve (printed), on the built-in fleet alike."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt

    bike = UserBike(DT).spec
    path = ("backward_batched_wide", "forward_batched", "forward_sweep")  # nxf 40: K3

    def fleet_of(b):
        return dtt.Fleet(tuple(b if i % 10 < 3 else dtt.UNICYCLE_4D if i % 10 < 7
                               else dtt.CAR_3D for i in range(N_AGENTS)), DT)

    custom, builtin = fleet_of(bike), fleet_of(dtt.BIKE_5D)
    cost, x0 = problem(custom, *swap_scenario(N_AGENTS, 0.55), torch.float64, dev)
    X = torch.as_tensor(x0, device=dev)[None]
    U = torch.as_tensor(np.random.default_rng(4).uniform(size=(HORIZON, N_AGENTS, 2))
                        * 0.01 * custom.control_mask, device=dev)

    def solve(fleet, backend, U=U):
        cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend=backend)
        res, counts = run_counted(lambda: dtt.solve_distributed(
            fleet, cost, X, U, RADIUS, K=8, config=cfg))
        if backend == "cuda":
            require(counts, path, "the mixed solve", solves=1)
            if fleet is custom:
                require_custom(counts, ("backward_batched_wide", "forward_batched",
                                        "forward_sweep"), "the mixed custom solve")
                for k in path:
                    launches[k] += counts[k]
            elif any(custom_counts().values()):
                fail("the built-in mixed fleet launched the custom-model library")
        else:
            no_sweep_kernel(counts)
        return res

    got, want = solve(custom, "cuda"), solve(builtin, "cuda")
    if int(got.sizes.min()) < 2:
        fail("the mixed custom scenario has an uncoupled agent")
    for name, a, b in zip(got._fields, got, want):
        if not torch.equal(a, b):
            fail(f"the mixed solve: {name} of the custom bicycles differs from Bike5D's")
    print(f"mixed solve (30 custom bicycles + 40 Unicycle4D + 30 Car3D, K=8, "
          f"neighbourhoods {int(got.sizes.min())}-{int(got.sizes.max())}, float64): "
          f"bit-equal to the fleet with Bike5D, J {float(got.J)!r}, mean iterations "
          f"{float(got.iters.float().mean())}", flush=True)

    # One iteration's kernels on the gathered batch, against their twins.
    args, sub_cost, mids, carry = sweep_inputs(custom, cost, x0, 8, dev)
    Kg, d = plain_backward(args)
    checks.compare("backward_batched_wide", "K3 mixed custom float64", ("Kg", "d"),
                   bt.backward_pass_batched_wide_cuda(*args), (Kg, d),
                   backward_tol(torch.float64))
    forward_checks(checks, {}, "mixed custom", custom, sub_cost, mids, carry, Kg, d,
                   torch.float64, dev)

    twin = solve(custom, "torch")
    nudged = solve(custom, "torch", U * (1 + 1e-13))
    print(f"mixed solve: kernels and twins differ in "
          f"{int((got.iters != twin.iters).sum())} of {N_AGENTS} iteration counts "
          f"(J {float(got.J)!r} / {float(twin.J)!r}); the twins' own solve with the "
          f"warm start times 1 + 1e-13 differs from it in "
          f"{int((twin.iters != nudged.iters).sum())} (J {float(nudged.J)!r})",
          flush=True)


def sharded_phase(dev, launches):
    """Phase 8e: ``solve_distributed_sharded`` of 100 Unicycle4D packed at
    spacing 0.55 (K=8, float64) on one card in one chunk and in two, each
    bit-equal to ``solve_distributed``; K1's and K2's widths per chunk."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import cuda_build

    fleet, cost, x0 = unicycle_problem(N_AGENTS, 0.55, torch.float64, dev)
    X = torch.as_tensor(x0, device=dev)[None]
    U = torch.as_tensor(np.random.default_rng(0).uniform(size=(HORIZON, N_AGENTS, 2)) * 0.01,
                        device=dev)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3)
    ref = dtt.solve_distributed(fleet, cost, X, U, RADIUS, K=8, config=cfg)
    for tag, mesh in (("one chunk", dtt.make_mesh()),
                      ("two chunks", dtt.make_mesh(["cuda:0", "cuda:0"]))):
        def run(mesh=mesh):
            with cuda_build.timed_launches() as record:
                out = dtt.solve_distributed_sharded(fleet, cost, X, U, RADIUS, mesh, K=8,
                                                    config=cfg)
            return out, record

        (res, record), counts = run_counted(run)
        require(counts, ("backward_batched", "forward_batched", "forward_sweep"),
                f"solve_distributed_sharded ({tag})", solves=1)
        for k in ("backward_batched", "forward_batched", "forward_sweep"):
            launches[k] += counts[k]
        for name, a, b in zip(res._fields, res, ref):
            if not torch.equal(a, b):
                fail(f"solve_distributed_sharded ({tag}): {name} differs from "
                     "solve_distributed")
        # The batch widths each chunk's K1 and K2 ran at, in launch order; a
        # chunk starts where the width grows.
        widths = {}
        for kernel in ("backward_batched", "forward_batched"):
            chunks = []
            for k, _, _, sizes in record:
                if k == kernel:
                    if not chunks or sizes[0] > chunks[-1][-1]:
                        chunks.append([])
                    chunks[-1].append(sizes[0])
            widths[kernel] = [sorted(set(c), reverse=True) for c in chunks]
        print(f"solve_distributed_sharded ({tag}): bit-equal to solve_distributed; "
              f"widths by chunk {json.dumps(widths)}", flush=True)
        if len(widths["backward_batched"]) != len(mesh) or any(
                len(w) < 2 for w in widths["backward_batched"]):
            fail(f"solve_distributed_sharded ({tag}): compaction did not fire in "
                 "every chunk")


def custom_phase(checks, results, dev, launches, UserBike):
    """Phase 8: custom models on the card and the sharded solve."""
    custom_checks(checks, results, dev, UserBike)
    custom_main_path(dev, launches, UserBike)
    custom_centralized(dev, launches, UserBike)
    custom_mixed(checks, dev, launches, UserBike)
    sharded_phase(dev, launches)


def plan_line(K, fleet, n_alpha, dtype, max_rows=0):
    """Phase 9e at one shape: the forward plan (K2, K4) as a line."""
    from dpilqr_tpu_torch.ops import cuda_build

    item = torch.empty((), dtype=dtype).element_size()
    plan = cuda_build.forward_plan(K, fleet.nx_p, fleet.nu_p, n_alpha, item,
                                   max_rows=max_rows)
    return (f"{plan.placement(K * fleet.nu_p)}: {plan.buffers} buffers of "
            f"{plan.rows} gain rows, {plan.warps} warps x {plan.chunks} CTAs, "
            f"{plan.nbytes} B")


def k4_tiles(checks, results, dev):
    """Phase 9a: K4 with gains on 100 Unicycle4D (the block in tiles)."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import cuda_build, ilqr, sweeps

    for dtype in (torch.float64, torch.float32):
        fleet, cost, x0 = unicycle_problem(100, 1.25, dtype, dev)
        rng = np.random.default_rng(4)
        U = torch.as_tensor(rng.uniform(size=(HORIZON, 100, 2)) * 0.1, dtype=dtype,
                            device=dev)
        X = ilqr._rollout_fn(fleet.step, cost, torch.as_tensor(x0, dtype=dtype,
                                                                device=dev), U)[0]
        mu = torch.tensor(1.0, dtype=dtype, device=dev)
        Kb, db = ilqr._backward_pass(fleet.linearize, cost, X, U, mu)
        alphas = dtt.ops.line_search_alphas(10, dtype, dev)
        fw = (cost, X, U, Kb, db, alphas)
        tag = f"K4 100 Unicycle4D tiles 10 alphas{'' if dtype == torch.float32 else ' float64'}"
        print(f"{tag}: {plan_line(100, fleet, 10, dtype)}", flush=True)
        checks.compare("forward_sweep", tag, ("X5", "U5", "J"),
                       sweeps.forward_pass_cuda(fleet, *fw),
                       ilqr._forward_pass(fleet.step, *fw), TOL[dtype])
        with cuda_build.timed_launches() as record:
            for _ in range(5):
                sweeps.forward_pass_cuda(fleet, *fw)
        results[tag] = (min(cuda_build.launch_ms(record, "forward_sweep")),
                        timed(lambda: ilqr._forward_pass(fleet.step, *fw), 2))
        checks.shapes[tag] = work_shape("forward_sweep", fleet, 100, 1, 10)
        print_result(checks, results, tag)


def k2_tiles(checks, results, dev):
    """Phase 9b: K2 on Quad12D at K=32 (nxf 384, nuf 128), S=16: a whole
    block in float32, tiles in float64."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt
    from dpilqr_tpu_torch.ops import cuda_build

    for dtype in (torch.float64, torch.float32):
        fleet, cost, x0 = quad_problem(dtt.QUAD_12D, 64, 0.7, dtype, dev)
        args, sub_cost, mids, carry = sweep_inputs(
            fleet, cost, x0, 32, dev, u_scale=1e-7, u_trim=np.array([0, 0, 0, HOVER["Quad12D"][1]]))
        args = cut_args(args, slice(None, None, 4))
        sub_cost = type(sub_cost)(*(a[::4].contiguous() for a in sub_cost))
        carry = type(carry)(*(a[::4].contiguous() for a in carry))
        mids = mids[::4].contiguous()
        Kg, d = plain_backward(args)
        for n_alpha in (2, 10):
            tag = (f"K2 Quad12D K=32 nxf 384 S={batch_width(args)} {n_alpha} alphas"
                   + ("" if dtype == torch.float32 else " float64"))
            print(f"{tag}: {plan_line(32, fleet, n_alpha, dtype)}", flush=True)
            fa = (fleet, sub_cost, mids, carry.X, carry.U, Kg, d,
                  dtt.ops.line_search_alphas(n_alpha, dtype, dev))
            checks.compare("forward_batched", tag, ("X5", "U5", "J"),
                           bt.forward_pass_batched_cuda(*fa),
                           bt.forward_pass_batched_torch(*fa), TOL[dtype])
            with cuda_build.timed_launches() as record:
                for _ in range(5):
                    bt.forward_pass_batched_cuda(*fa)
            results[tag] = (min(cuda_build.launch_ms(record, "forward_batched")),
                            timed(lambda: bt.forward_pass_batched_torch(*fa), 1))
            checks.shapes[tag] = work_shape("forward", fleet, 32, batch_width(args), n_alpha)
            print_result(checks, results, tag)


def forced_tiles(dev):
    """Phase 9c: tiles forced where a whole block fits must give its bits:
    K2 at the main path's shape (S=100, K=8) and on Quad6D at K=16 (S=64),
    K4 at the 10-agent centralized shape."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt
    from dpilqr_tpu_torch.ops import ilqr, sweeps

    for dtype in (torch.float64, torch.float32):
        cases = (
            ("main path S=100 K=8", unicycle_problem(N_AGENTS, 0.55, dtype, dev), 8,
             {}, (4, 8)),
            ("Quad6D K=16 S=64", quad_problem(dtt.QUAD_6D, 64, 0.7, dtype, dev), 16,
             dict(u_scale=0.01, u_trim=np.array([G, 0, 0])), (4, 16, 28)),
        )
        for name, (fleet, cost, x0), K, kw, rows_list in cases:
            args, sub_cost, mids, carry = sweep_inputs(fleet, cost, x0, K, dev, **kw)
            Kg, d = bt.backward_pass_batched(*args, "cuda")
            fa = (fleet, sub_cost, mids, carry.X, carry.U, Kg, d,
                  dtt.ops.line_search_alphas(10, dtype, dev))
            whole = bt.forward_pass_batched_cuda(*fa)
            for rows in rows_list:
                plan = plan_line(K, fleet, 10, dtype, rows)
                same = bits_agree(bt.forward_pass_batched_cuda(*fa, max_rows=rows), whole)
                print(f"K2 {name} {str(dtype)[6:]} forced {plan}: the whole block's "
                      f"bits {same}", flush=True)
                if not same:
                    fail(f"K2 {name} {dtype}: tiles of {rows} rows change the bits")
        fleet, cost, X, U = k5_problems(dtype, dev)["10 Unicycle4D"]
        mu = torch.tensor(1.0, dtype=dtype, device=dev)
        Kb, db = ilqr._backward_pass(fleet.linearize, cost, X, U, mu)
        fw = (cost, X, U, Kb, db, dtt.ops.line_search_alphas(10, dtype, dev))
        whole = sweeps.forward_pass_cuda(fleet, *fw)
        for rows in (4, 8):
            plan = plan_line(10, fleet, 10, dtype, rows)
            same = bits_agree(sweeps.forward_pass_cuda(fleet, *fw, max_rows=rows), whole)
            print(f"K4 10 Unicycle4D {str(dtype)[6:]} forced {plan}: the whole "
                  f"block's bits {same}", flush=True)
            if not same:
                fail(f"K4 {dtype}: tiles of {rows} rows change the bits")


def wide_centralized(dev, launches):
    """Phase 9d: ``ilqr_solve`` of 100 Unicycle4D (float64, K5 in tier 2 and
    K4 in tiles) on the kernels beside the twins, then 2 steps of
    ``solve_rhc(centralized=True)`` in float32."""
    import dpilqr_tpu_torch as dtt

    fleet, cost, x0 = unicycle_problem(100, 1.25, torch.float64, dev)
    x0_t = torch.as_tensor(x0, device=dev)
    res, ms = {}, {}
    for backend in ("cuda", "torch"):
        cfg = dtt.SolverConfig(n_lqr_iter=5, tol=1e-3, sweep_backend=backend)

        def run(cfg=cfg, x0_t=x0_t):
            t0 = time.perf_counter()
            r = dtt.ilqr_solve(fleet, cost, x0_t, N=HORIZON, config=cfg)
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t0) * 1e3

        (res[backend], ms[backend]), counts = run_counted(run)
        if backend == "cuda":
            require(counts, ("backward_sweep", "forward_sweep"), "ilqr_solve (100 unicycles)")
            if any(counts[k] for k in counts if k not in ("backward_sweep", "forward_sweep")):
                fail(f"ilqr_solve (100 unicycles) launched other kernels: {counts}")
            launches["forward_sweep"] += counts["forward_sweep"]
            launches[f"per centralized solve (100 unicycles, {int(res[backend].iters)} "
                     "iterations)"] = {k: counts[k] for k in ("backward_sweep", "forward_sweep")}
        elif any(counts.values()):
            fail("the torch backend launched a kernel")
    a, b = res["cuda"], res["torch"]
    summary = {k: {"ms": ms[k], "iters": int(res[k].iters), "converged": bool(res[k].converged),
                   "failed_line_search": bool(res[k].failed_line_search), "J": float(res[k].J)}
               for k in res}
    print("ilqr_solve 100 Unicycle4D float64: " + json.dumps(summary), flush=True)
    if not int(a.iters) > 1:
        fail("ilqr_solve (100 unicycles) is no solve: one iteration or none")
    dJ = abs(float(a.J) - float(b.J)) / abs(float(b.J))
    if (int(a.iters) != int(b.iters) or bool(a.converged) != bool(b.converged)
            or bool(a.failed_line_search) != bool(b.failed_line_search) or not dJ <= 1e-9):
        # Whether the scenario's conditioning alone moves the twins that far.
        moved = dtt.ilqr_solve(fleet, cost, x0_t + 1e-13, N=HORIZON,
                               config=dtt.SolverConfig(n_lqr_iter=5, tol=1e-3,
                                                       sweep_backend="torch"))
        print(f"twins against twins with x0 + 1e-13: iters {int(moved.iters)} vs "
              f"{int(b.iters)}, rel J {abs(float(moved.J) - float(b.J)) / abs(float(b.J)):.3e}")
        fail(f"ilqr_solve (100 unicycles) float64: kernels and twins part (rel J {dJ:.3e})")
    print(f"ilqr_solve 100 Unicycle4D float64: kernels and twins equal in iterations "
          f"and flags, rel J {dJ:.3e}", flush=True)
    fleet, cost, x0 = unicycle_problem(100, 1.25, torch.float32, dev)
    kern, counts = run_counted(lambda: rhc_run(fleet, cost, x0, "cuda", 2, centralized=True))
    require(counts, ("backward_sweep", "forward_sweep"), "solve_rhc(centralized=True), 100 agents")
    launches["forward_sweep"] += counts["forward_sweep"]
    print(f"centralized loop 100 Unicycle4D float32 (kernels, launches {counts}): "
          + json.dumps(kern), flush=True)


def plan_limits():
    """Phase 9e, the one-column limit: the last Unicycle4D fleet the forward
    plan places and the first it does not, in both types."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import cuda_build

    for dtype, last in ((torch.float32, 1709), (torch.float64, 854)):
        item = torch.empty((), dtype=dtype).element_size()
        print(f"forward plan at {last} Unicycle4D {str(dtype)[6:]}: "
              f"{plan_line(last, dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 1, DT), 10, dtype)}")
        try:
            cuda_build.forward_plan(last + 1, 4, 2, 10, item)
            fail(f"the plan places {last + 1} Unicycle4D in {dtype}")
        except ValueError:
            pass
    print("forward plans: every shape of phase 9 placed, none past one column",
          flush=True)


def forward_tiles_phase(checks, results, dev, launches):
    """Phase 9: the forward kernels past one stage."""
    t0 = time.perf_counter()
    k4_tiles(checks, results, dev)
    k2_tiles(checks, results, dev)
    forced_tiles(dev)
    wide_centralized(dev, launches)
    plan_limits()
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)


def bench_phase(dev):
    """Phase 10: every point of ``bench_torch.py`` on the card at full width,
    one timed repeat, closed loops cut to ``BENCH_MPC_STEPS`` steps; every
    kernel must launch, every point must hold its time, spread and quality
    keys, each point's own run must have gone through its kernels
    (``bench_torch.card_faults``), and no point may fail or leave a
    canonical key missing."""
    t0 = time.perf_counter()
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    rc, counts = run_counted(lambda: bench_torch.main(
        ["--reps", "1"], mpc_steps=BENCH_MPC_STEPS, emit=emit))
    print(f"bench_torch launches (every point): {json.dumps(counts)}", flush=True)
    require(counts, KERNELS, "bench_torch.py")
    rec = json.loads(lines[-1])
    setting = bench_torch.Setting(device=dev)
    for line in lines[:-1]:
        point = json.loads(line)
        name = point["point"]
        errors = [k for k in point if k.endswith("_error")]
        if errors:
            fail(f"bench_torch point {name} failed: {point[errors[0]]}")
        missing = [k for k in bench_torch.expected_keys(name, setting) if point.get(k) is None]
        if missing:
            fail(f"bench_torch point {name} lacks {missing}")
        faults = bench_torch.card_faults(name, point)
        if faults:
            fail(f"bench_torch point {name} left its kernels: {faults}")
    if rec["extra"].get("incomplete") or rc != 0:
        fail(f"bench_torch.py exits {rc}, incomplete: {rec['extra'].get('incomplete')}")
    print(f"phase 10: {time.perf_counter() - t0:.1f} s, {len(lines) - 1} points, "
          f"ms_100_distributed {rec['value']}, vs_baseline {rec['vs_baseline']}", flush=True)


def random_accept_inputs(S, dtype, dev, rng, tail):
    """A random accept step at the main path's shape (N=50, K=8, Unicycle4D,
    10 alphas) and width ``S``: candidates, their costs (the tail's +inf
    where ``tail`` is False, as its skipped launch leaves them), the start
    states and a carry with some lanes inactive or converged."""
    from dpilqr_tpu_torch.ops import batched as bt

    n_alpha, K, nx, nu = 10, 8, 4, 2

    def t(a, dt=dtype):
        return torch.as_tensor(a).to(dt).to(dev)

    X5 = t(rng.standard_normal((n_alpha, S, HORIZON, K, nx)))
    U5 = t(rng.standard_normal((n_alpha, S, HORIZON, K, nu)))
    J_c = t(rng.uniform(0.5, 1.5, (n_alpha, S)))
    if not tail:
        J_c[2:] = float("inf")
    carry = bt.BatchCarry(
        X=t(rng.standard_normal((S, HORIZON + 1, K, nx))),
        U=t(rng.standard_normal((S, HORIZON, K, nu))), J=t(rng.uniform(0.52, 1.2, S)),
        mu=t(rng.choice([1e-7, 1e-6, 0.5, 1.5, 700.0], S)),
        delta=t(rng.choice([0.25, 1.0, 4.0], S)), i=t(rng.integers(0, 15, S), torch.int32),
        converged=t(rng.uniform(size=S) < 0.1, torch.bool),
        failed=torch.zeros(S, dtype=torch.bool, device=dev),
        active=t(rng.uniform(size=S) < 0.85, torch.bool))
    inv = bt._inverse(bt.COLUMN_ORDER)
    return X5.permute(inv), U5.permute(inv), J_c, t(rng.standard_normal((S, K, nx))), carry


def accept_bytes(X5, U5, J_c, carry):
    """The bytes one accept launch must move on these inputs: the J_c entries
    each subproblem reads (up to its first improving alpha), its scalars
    read and written, and for each updated subproblem its candidate rows
    read, its start state read and its X and U rows written."""
    n_alpha, S = J_c.shape
    item = J_c.element_size()
    improved = J_c < carry.J[None]
    accept = improved.any(0)
    first = torch.argmax(improved.to(torch.int32), 0)
    reads = int(torch.where(accept, first + 1, n_alpha).sum())
    upd = int((accept & carry.active).sum())
    N, nx_p, K = X5.shape[0], X5.shape[1], X5.shape[2]
    row = N * K * (nx_p + U5.shape[1])
    return (reads * item + S * 2 * (3 * item + 4 + 3)
            + upd * (2 * row + 2 * K * nx_p) * item + 8)


def accept_checks(checks, results, dev):
    """Phase 11a: the accept kernel against ``accept_batched_torch``, bit for
    bit, at S = 100 and 800, both types, with and without the tail, both
    ``on_failed_ls`` modes (``mu_floor`` with "increase"); timed at the main
    path's S = 100 in float32: 50 launches on fresh carries replayed as one
    graph an event pair, the wrapper's and the plain version's calls
    beside."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt

    rng = np.random.default_rng(11)
    for S in (100, 800):
        for dtype in (torch.float32, torch.float64):
            for tail in (True, False):
                for mode in ("bail", "increase"):
                    X5, U5, J_c, x0, carry = random_accept_inputs(S, dtype, dev,
                                                                  rng, tail)
                    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-2, on_failed_ls=mode,
                                 mu_floor=mode == "increase")
                    outs = []
                    for fn in (bt.accept_batched_cuda, bt.accept_batched_torch):
                        c = bt.BatchCarry(*(a.clone() for a in carry))
                        counter = torch.zeros(2, dtype=torch.int32, device=dev)
                        fn(cfg, X5, U5, J_c, x0, c, counter)
                        outs.append((c, counter))
                    torch.cuda.synchronize()
                    (got, n_got), (want, n_want) = outs
                    err = max(float((a.double() - b.double()).abs().max())
                              for a, b in zip((*got, n_got), (*want, n_want)))
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    tag = f"accept S={S} {str(dtype)[6:]} tail={tail} {mode}"
                    print(f"{tag}: bit-equal {same}, max abs err {err}, active "
                          f"{int(n_got[0])}/{S}", flush=True)
                    if not (same and torch.equal(n_got, n_want)):
                        fail(f"the accept kernel disagrees with its plain version ({tag})")
                    checks.worst["accept_batched"] = max(
                        checks.worst.get("accept_batched", 0.0), err)
    X5, U5, J_c, x0, carry = random_accept_inputs(100, torch.float32, dev, rng, True)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3)
    label = "accept S=100 K=8 10 alphas"
    times = {}
    counter = torch.zeros(2, dtype=torch.int32, device=dev)

    def fresh(reps):
        return [bt.BatchCarry(*(a.clone() for a in carry)) for _ in range(reps)]

    def event_ms(fn, reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    # The kernel: 50 launches on 50 fresh carries, captured as one graph (as
    # the solve replays it), so that the time is the device's, not the
    # wrapper's; the wrapper's (accept_batched_cuda, its checks and binding
    # each call) and the plain version's on fresh carries beside it.
    for fn in (bt.accept_batched_cuda, bt.accept_batched_torch):
        fn(cfg, X5, U5, J_c, x0, fresh(1)[0], counter)  # warm-up
    order = bt.COLUMN_ORDER
    bound = [bt._bind_accept(cfg, X5.permute(order), U5.permute(order), J_c, x0, c,
                             counter) for c in fresh(50)]  # each holds its carry
    graph, _ = bt._capture(bound, dev)
    times["kernel"] = event_ms(graph.replay, 50)
    for name, fn, reps in (("wrapper", bt.accept_batched_cuda, 50),
                           ("plain", bt.accept_batched_torch, 10)):
        carries = fresh(reps)
        times[name] = event_ms(lambda: [fn(cfg, X5, U5, J_c, x0, c, counter)
                                        for c in carries], reps)
    results[label] = (times["kernel"], times["plain"])
    checks.shapes[label] = (0.0, 0.0, accept_bytes(X5, U5, J_c, carry))
    print_result(checks, results, label)
    print(f"{label}: the wrapper a call (checks, binding, launch) {times['wrapper']:.4f} ms",
          flush=True)


def tail_checks(dev):
    """Phase 11b: K2's tail under its predicate against the unpredicated
    launch at the main path's shape (S=100, K=8, alphas 3-10 after a probe
    of 2): the same bits where an active subproblem improved at no probe
    alpha, J = +inf where none needs the tail; both types."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt

    for dtype in (torch.float32, torch.float64):
        fleet, cost, x0 = unicycle_problem(N_AGENTS, 0.55, dtype, dev)
        args, sub_cost, mids, carry = sweep_inputs(fleet, cost, x0, 8, dev)
        Kg, d = bt.backward_pass_batched(*args, "cuda")
        alphas = dtt.ops.line_search_alphas(10, dtype, dev)
        fa = (fleet, sub_cost, mids, carry.X, carry.U, Kg, d)
        J_probe = bt.forward_pass_batched_cuda(*fa, alphas[:2])[2]
        plain = bt.forward_pass_batched_cuda(*fa, alphas[2:])
        active = carry.active.clone()
        need = J_probe.min(0).values  # no subproblem improves at a probe alpha
        got = bt.forward_pass_batched_cuda(*fa, alphas[2:], tail=(J_probe, need, active))
        skip = torch.full_like(need, float("inf"))
        skipped = bt.forward_pass_batched_cuda(*fa, alphas[2:],
                                               tail=(J_probe, skip, active))[2]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, plain))
        inf = bool(torch.isinf(skipped).all()) and bool((skipped > 0).all())
        print(f"K2 tail {str(dtype)[6:]}: predicate true bit-equal to the unpredicated "
              f"launch {same}; false: J = +inf {inf}", flush=True)
        if not (same and inf):
            fail(f"K2's predicated tail is wrong ({str(dtype)[6:]})")


def mpc_result(fleet, cost, x0, dtype, steps=MPC_STEPS):
    """The main path's closed loop (``rhc_run``'s settings) and its wall ms
    a step."""
    import dpilqr_tpu_torch as dtt

    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dtt.solve_rhc(fleet, cost, x0.astype(dtype), HORIZON, radius=RADIUS,
                        centralized=False, step_size=1, J_converge=1e-3,
                        t_diverge=(steps - 1) * DT, config=cfg,
                        rng=np.random.default_rng(0), device=cost.xf.device)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3 / len(res.steps)


def graph_path(dev):
    """Phase 11c: the 100-agent main path, 5 MPC steps, on the graphs against
    the eager kernel path (``batched_iteration`` a width, the module's own
    stage), float32 and float64: X, U, J, iterations and converged flags
    bit-equal; ms a step both ways in turns (median, min-max over 3 runs
    each); the graphs cached and their bytes; the device's busy share of a
    traced loop (``bench_torch.device_busy``)."""
    from dpilqr_tpu_torch.ops import batched as bt

    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        fleet, cost, x0 = unicycle_problem(N_AGENTS, 1.25, dtype, dev)
        graph_stage = bt._graph_stage

        def eager(fn):
            bt._graph_stage = bt._eager_stage
            try:
                return fn()
            finally:
                bt._graph_stage = graph_stage

        run = lambda: mpc_result(fleet, cost, x0, np_dtype)  # noqa: E731
        ms = {"graph": [], "eager": []}
        out = {}
        for mode in ("graph", "eager", "eager", "graph", "graph", "eager"):
            (res, step_ms), counts = run_counted(
                run if mode == "graph" else lambda: eager(run))
            ms[mode].append(step_ms)
            out[mode] = (res, counts)
        (g, gc), (e, ec) = out["graph"], out["eager"]
        same = (np.array_equal(g.X, e.X) and np.array_equal(g.U, e.U) and g.J == e.J
                and all(a.iters == b.iters and a.converged == b.converged and a.J == b.J
                        for a, b in zip(g.steps, e.steps)))
        tag = str(dtype)[6:]
        summary = {m: {"ms_per_step_median": float(np.median(v)), "min": min(v),
                       "max": max(v)} for m, v in ms.items()}
        print(f"main path on the graphs against the eager kernel path, {tag}: "
              f"bit-equal {same}; " + json.dumps(summary) + "; launches (graph) "
              + json.dumps({k: v for k, v in gc.items() if v})
              + " (eager) " + json.dumps({k: v for k, v in ec.items() if v}), flush=True)
        if not same:
            fail(f"the graph path's main path differs from the eager kernel path ({tag})")
        for k in ("backward_batched", "forward_batched", "accept_batched"):
            if gc[k] != ec[k]:
                fail(f"{k}: {gc[k]} launches on the graphs, {ec[k]} eagerly ({tag})")
    print("graph cache: " + json.dumps(bt.graph_cache_info()), flush=True)
    s = bench_torch.Setting(device=dev, horizon=HORIZON)
    busy = bench_torch.device_busy(s, N_AGENTS, MPC_STEPS)
    print(f"main path ({MPC_STEPS} steps, float32) under the profiler: "
          + json.dumps(busy), flush=True)


def graph_phase(checks, results, dev, launches):
    """Phase 11: the batched solve's device-side loop."""
    t0 = time.perf_counter()
    accept_checks(checks, results, dev)
    tail_checks(dev)
    graph_path(dev)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)


def build_phase():
    """Phase 2: the default library and the custom-model one of phase 8 (K1
    to K5 with the user bicycle's generated right-hand side), built
    together; returns the user bicycle's class."""
    from concurrent.futures import ThreadPoolExecutor

    from dpilqr_tpu_torch.ops import codegen, cuda_build

    UserBike = user_bike_class()
    header = codegen.generate_header((UserBike(DT).spec,))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        custom_build = pool.submit(cuda_build.build, True, header)
        lib, build_s = cuda_build.build(verbose=True)
        custom_lib, custom_s = custom_build.result()
    both_s = time.perf_counter() - t0
    cuda_build.load_library()
    cuda_build.load_library(header)
    print(f"build: {build_s:.1f} s; custom-model build (K1 to K5 with the user "
          f"bicycle's generated right-hand side, {cuda_build.build_dir(header).name}): "
          f"{custom_s:.1f} s; both together {both_s:.1f} s", flush=True)
    for source in ("forward_batched", "backward_batched"):
        regs = {tag: print_registers(tag, path, source, f"{source}_kernel")
                for tag, path in (("default build", lib), ("custom build", custom_lib))}
        if all(regs.values()):
            print(f"{source} registers, custom build against default: " + json.dumps(
                {k: [regs["custom build"][k]["registers"],
                     regs["default build"][k]["registers"]]
                 for k in regs["custom build"]}), flush=True)
    return UserBike


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the GPU path only")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi_line}", flush=True)

    UserBike = build_phase()

    checks, results = Checks(), {}
    narrow_checks(checks, results, dev)
    wide_checks(checks, results, dev)
    centralized_checks(checks, results, dev)
    rollout_checks(checks, results, dev)
    probe_plain_ms = probe_checks(checks, dev)
    for label in results:
        print_result(checks, results, label)

    launches = {"forward_sweep": 0}  # K4 runs on every path: summed over them
    main_path(dev, launches)
    quad6d_loop(dev, launches)
    quad12d_solve(dev)
    centralized_paths(dev, launches)
    solve_parity(dev)
    sol_phase(checks, results, probe_plain_ms, dev, launches)
    deadline_phase(dev)
    facade_phase(checks, results, dev, launches)
    custom_phase(checks, results, dev, launches, UserBike)
    forward_tiles_phase(checks, results, dev, launches)
    bench_phase(dev)
    graph_phase(checks, results, dev, launches)

    timing = {"backward_batched": "K1", "forward_batched": "K2 nxf 32 2 alphas",
              "backward_batched_wide": "K3 Quad6D K=16 nxf 96",
              "forward_sweep": "K4 10 alphas",
              "backward_sweep": "K5", "probe_fma": "K6", "probe_hbm": "K7",
              "probe_sin": "K8", "accept_batched": "accept S=100 K=8 10 alphas"}
    # The other shapes the redesigned kernels were timed at.
    others = {"backward_batched": "K1 ", "forward_batched": "K2 ",
              "backward_batched_wide": "K3 ", "forward_sweep": "K4 ",
              "backward_sweep": "K5 "}
    kernels = []
    for key, (fn, replaces) in KERNELS.items():
        ms, plain_ms = results[timing[key]]
        # The least time by the H100's published peaks for the timed launch's
        # work: its shapes for a sweep, (FLOPs, sines, bytes) for a probe.
        b_ms, bound_by = bound_ms(checks.shapes[timing[key]])
        entry = {
            "name": fn, "route": "cuda", "source": f"dpilqr_tpu_torch/csrc/{key}.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": checks.worst[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": bound_by,
            "library_ms": checks.library_ms.get(key)}
        if key in others:
            entry["shapes"] = [
                dict(zip(("shape", "ms", "plain_ms", "bound_ms", "bound_by"),
                         (label, *results[label], *bound_ms(checks.shapes[label]))))
                for label in results
                if label.startswith(others[key]) and label != timing[key]
                and label in checks.shapes]
        kernels.append(entry)
        print(f"{key} ({timing[key]}): {ms:.4f} ms, bound {b_ms:.5f} ms by "
              f"{bound_by} (share {b_ms / ms:.5f}), launches {launches[key]}, "
              f"launches x (ms - bound) {launches[key] * (ms - b_ms):.2f} ms")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
