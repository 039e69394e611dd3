#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``dpilqr_tpu_torch``) on one GPU.

The port's counterpart of ``bench.py``: the same points, run through the
port's entry points, each time with its spread and the quality of the plan
beside it.  It imports torch, numpy and ``dpilqr_tpu_torch`` only (the
numpy oracle of ``tests/oracle.py`` for the baseline), never JAX or
``dpilqr_tpu``.

    python3 bench_torch.py [--point NAME ...] [--dtype float32|float64]
                           [--reps K] [--device cuda|cpu] [--seed S]
    python3 bench_torch.py --list

With no ``--point`` every point runs, in ``bench.py``'s order.  Each point
prints one JSON line as it finishes; the last line is the record, shaped as
``bench.py``'s: ``metric``, ``value`` (the median ``ms_100_distributed``),
``unit``, ``vs_baseline`` and ``extra``.  Without a CUDA device the bench
raises unless ``--device cpu`` is given.

Timing.  A solve is timed on the host clock with the device synchronized
before and after it, after one warm-up call, ``--reps`` times (default 5):
``ms_<key>`` is the median, ``ms_<key>_min`` and ``ms_<key>_max`` beside it
(``hz_<key>`` from the median).  A closed loop is timed the same way over
whole loops, in ms per MPC step.  Kernel-level times (the ``sol`` point)
are ``utils.profiling.cuda_min_ms``'s, as ``utils.sol.sol_report`` takes
them.

Quality.  Every decomposed point records, under its tag, ``conv_frac_``,
``J_`` (the stitched or executed joint cost), ``iters_`` (the sum over
subproblems, as ``bench.py``), ``mean_iters_``, ``max_nbhd_`` (the largest
neighbourhood), ``non_solve_`` (true where the mean iterations per
subproblem are <= 1: not a solve), ``backend_`` (``cuda`` or ``torch``),
``backward_`` (the backward kernel that ran: ``K1``, ``K3``, ``K1+K3`` or
``twin``) and ``launches_`` (each kernel's launches in one warm-up run);
``centralized_10`` records ``iters_``, ``J_``, ``converged_`` and the same
three path keys (its backward kernel ``K5``).  A point run with ``K``
pinned fails where a neighbourhood outgrew it.  On the card,
``card_faults`` names a point whose record shows that it left its kernels.

Errors.  A point that raises records ``<point>_error`` and the others still
run.  ``incomplete`` lists each canonical key of the points run that is
missing.  The process prints the record, then exits 1 if a point failed or
``incomplete`` is not empty.

Points (``--list``), with ``bench.py``'s keys:

- ``distributed_50`` / ``_100`` / ``_250`` / ``_500``: one cold
  ``solve_distributed`` of n Unicycle4D (``grid_scenario``, K = 8, N = 50);
  ``ms_<n>_distributed``; ``_100`` also ``riccati_block_nnz_per_s``.
- ``mpc_100`` (auto K), ``mpc_250``, ``mpc_500`` (K = 8, 15 steps),
  ``mpc_quad6d_64`` (auto K), ``mpc_100_tkill`` (K = 8, ``t_kill = dt``):
  ``closed_loop_run``, ``ms_per_mpc_step_<name>``; ``_tkill`` also
  ``deadline_capped_frac_100_tkill``, ``max_solve_ms_100_tkill`` and
  ``host_sync_us_100_tkill``.  On the card ``mpc_100`` also records
  ``device_busy_frac_mpc_100``: the device's busy share over one more
  loop traced by ``utils.profiling.trace`` in a child process.
- ``centralized_10``: ``make_solver`` on ``random_setup(10, 4, energy 10,
  seed 12345)``, ``tol = 1e-9``: ``ms_10_centralized``.
- ``baseline``: the numpy oracle's ms an iteration on one K = 8
  subproblem; with ``distributed_100`` it gives ``vs_baseline``.
- ``distributed_ws_100`` / ``_250`` / ``_500``: ``selfish_warmstart`` and
  the coupled solve, end to end: ``ms_<n>_distributed_ws``,
  ``J_ws_over_cold_<n>``.
- ``quad6d_64``, ``quad12d_16``, ``quad12d_64`` (K = 4), ``quad12d_64_k8``,
  ``hetero_99``: ``bench.py``'s model family, ``ms_<name>_distributed``.
- ``sol``: ``utils.sol.sol_report`` (K6-K8 run, K1-K5 timed; card only):
  ``backward_sol_frac``, ``forward_sol_frac``, ``forward_trig_time_frac``,
  ``pscan_sol_frac_fair`` and the rest of ``bench.py``'s ``_sol_extras``.
  ``bench.py``'s ``vpu_ceiling_gflop_s`` is ``fma_ceiling_gflop_s`` here and
  ``mxu_ceiling_gflop_s`` is ``matmul_ceiling_gflop_s`` (the card's units);
  ``sol_<kernel>_ms`` and ``sol_<kernel>_published_frac`` time each kernel.
- ``trials_8x100``: 8 trials of 100 Unicycle4D (swap scenario, spacing
  1.25, seeds 0-7), one ``solve_trials_sharded`` at K = 8 (S = 800):
  ``ms_trials_8x100``.
- ``mpc_bike_custom_100``: ``mpc_100``'s loop on 100 bicycles of a sympy
  ``SymbolicModel`` (the custom-model build): ``ms_per_mpc_step_bike_custom_100``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
import tempfile
import traceback
from functools import partial
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.config import default_device, resolve_backend
from dpilqr_tpu_torch.ops import cuda_build
from dpilqr_tpu_torch.ops.ilqr import resolve_sweep_backend
from dpilqr_tpu_torch.parallel.mesh import stack_costs
from dpilqr_tpu_torch.utils import sol
from dpilqr_tpu_torch.utils.metrics import riccati_block_nnz
from dpilqr_tpu_torch.utils.profiling import trace

REPO = Path(__file__).resolve().parent
HORIZON, DT, RADIUS, K_SLOTS = 50, 0.1, 0.5, 8
MEASURED_OVER_PROJECTED = 0.455  # bench.py: the measured baseline run over its projection
# The launch-count keys of ``ops.cuda_build`` by the kernels' names in PERF.md.
KERNEL_IDS = {"backward_batched": "K1", "forward_batched": "K2",
              "backward_batched_wide": "K3", "forward_sweep": "K4",
              "backward_sweep": "K5", "probe_fma": "K6", "probe_hbm": "K7",
              "probe_sin": "K8", "accept_batched": "accept"}


# The suffixes of a point's keys under its tag: what ``quality``,
# ``path_keys`` and ``traced_loop`` produce, and what ``expected_keys`` asks.
QUALITY = ("conv_frac", "J", "iters", "mean_iters", "max_nbhd", "non_solve")
CENTRALIZED = ("iters", "J", "converged")
PATH = ("backend", "backward", "launches")
BUSY = ("device_busy_frac", "device_busy_ms_per_step", "traced_ms_per_step",
        "traced_device_events")


# --- Builders: bench.py's numpy scenarios, copied as they are. -------------

def grid_scenario(n, spacing=0.75, seed=0):
    """Constant-density start/goal sets (``bench.py`` ``_grid_scenario``):
    jittered grid, goals mirrored so trajectories cross."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    pts = np.stack(
        np.meshgrid(np.arange(side), np.arange(side)), -1
    ).reshape(-1, 2)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, 4))
    x0[:, :2] = pts
    xf = np.zeros((n, 4))
    xf[:, :2] = pts[::-1] + rng.uniform(-0.05, 0.05, pts.shape)
    return x0, xf


def swap_scenario(n, spacing=0.75, seed=0):
    """Constant-density start/goal sets with local crossings (``bench.py``
    ``_swap_scenario``): adjacent grid columns swap positions."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pts = np.stack([ii, jj], -1).reshape(-1, 2)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    col = (np.arange(n) % side)
    partner = np.where(
        (col % 2 == 0) & (col + 1 < side),
        np.arange(n) + 1,
        np.where(col % 2 == 1, np.arange(n) - 1, np.arange(n)),
    )
    # Truncated grids (side^2 > n): a last agent's partner may fall off the
    # end -- keep it in place instead.
    partner = np.where(partner < n, partner, np.arange(n))
    goals = pts[partner] + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, 4))
    x0[:, :2] = pts
    xf = np.zeros((n, 4))
    xf[:, :2] = goals
    return x0, xf


def grid3d_scenario(n, spacing=0.75, nx=6, seed=0):
    """The quadrotor swarm's scenario (``bench.py`` ``_grid3d_scenario``):
    agents on a jittered 3D grid swap with their lateral neighbour."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1.0 / 3.0)))
    ii, jj, kk = np.meshgrid(
        np.arange(side), np.arange(side), np.arange(side), indexing="ij"
    )
    pts = np.stack([ii, jj, kk], -1).reshape(-1, 3)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    col = np.arange(n) % side
    partner = np.where(
        (col % 2 == 0) & (col + 1 < side),
        np.arange(n) + 1,
        np.where(col % 2 == 1, np.arange(n) - 1, np.arange(n)),
    )
    # Truncated grids (side^3 > n): a last agent's partner may fall off the
    # end -- keep it in place instead.
    partner = np.where(partner < n, partner, np.arange(n))
    goals = pts[partner] + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, nx))
    x0[:, :3] = pts
    xf = np.zeros((n, nx))
    xf[:, :3] = goals
    return x0, xf


def user_bike_class():
    """A facade ``SymbolicModel`` bicycle whose sympy field is ``Bike5D``'s:
    a custom model, run in the kernels through the generated right-hand
    side (imports sympy)."""
    import sympy as sym

    from dpilqr_tpu_torch import api

    class UserBike(api.SymbolicModel):
        def __init__(self, dt, id=None, device=None):
            super().__init__(5, 2, dt, id, device=device)
            x = sym.Matrix(sym.symbols("p_x p_y v theta phi"))
            u = sym.Matrix(sym.symbols("a rho"))
            x_dot = sym.Matrix([x[2] * sym.cos(x[3]), x[2] * sym.sin(x[3]), u[0],
                                x[2] * sym.tan(x[4]), u[1]])
            self._build(x, u, x_dot)

    return UserBike


@dataclasses.dataclass(frozen=True)
class Setting:
    """What every point runs at: the device and type, the timed repeats,
    the workload seed (0 gives ``bench.py``'s data), the horizon, and two
    cuts for short runs: ``mpc_steps`` (None: each loop's own 20 or 15
    steps) and ``max_agents`` (None: each point's own fleet)."""

    device: torch.device
    dtype: torch.dtype = torch.float32
    reps: int = 5
    seed: int = 0
    horizon: int = HORIZON
    mpc_steps: int | None = None
    max_agents: int | None = None

    def __post_init__(self):
        if self.reps < 1 or self.horizon < 1:
            raise ValueError("reps and horizon must be positive")

    @property
    def np_dtype(self):
        return np.float64 if self.dtype == torch.float64 else np.float32

    def agents(self, n, multiple=1):
        """A point's fleet size ``n`` under ``max_agents``, rounded down to
        a ``multiple`` (at least one)."""
        if self.max_agents is not None:
            n = max(multiple, min(n, self.max_agents) // multiple * multiple)
        return n

    def steps(self, n_steps):
        return n_steps if self.mpc_steps is None else self.mpc_steps

    def config(self, **kw):
        return dtt.SolverConfig(n_lqr_iter=15, **{"tol": 1e-3, **kw})


def game_cost(s, fleet, xf, n_pos=None):
    """Q = I, R = I, Qf = 1e3 I and the proximity radius 0.5 for ``fleet``,
    in the setting's type and on its device."""
    n, nx, nu = fleet.n_agents, fleet.nx_p, fleet.nu_p
    return dtt.make_game_cost(
        xf, np.tile(np.eye(nx), (n, 1, 1)), np.tile(np.eye(nu), (n, 1, 1)),
        np.tile(1e3 * np.eye(nx), (n, 1, 1)), radius=RADIUS,
        n_pos=None if n_pos is None else np.full((n,), n_pos, np.int32),
        dtype=s.dtype, device=s.device,
    )


def padded(fleet, pos):
    """``pos (n, 2)`` positions as ``(n, nx_p)`` states, the rest zero."""
    x = np.zeros((fleet.n_agents, fleet.nx_p))
    x[:, :2] = pos[:, :2]
    return x


def cl_problem(s, n, model="unicycle"):
    """Fleet, cost and x0 of a closed-loop workload (``bench.py``
    ``_cl_problem``): "unicycle" (2D swap scenario, spacing 1.25),
    "quad6d" (3D local-crossing grid, spacing 0.85, n_pos 3) or
    "bike_custom" (the unicycles' scenario on ``user_bike_class``)."""
    if model == "quad6d":
        x0, xf = grid3d_scenario(n, spacing=0.85, nx=6, seed=s.seed)
        fleet = dtt.homogeneous_fleet(dtt.QUAD_6D, n, DT)
        return fleet, game_cost(s, fleet, xf, n_pos=3), x0
    x0, xf = swap_scenario(n, spacing=1.25, seed=s.seed)
    if model == "unicycle":
        fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, DT)
        return fleet, game_cost(s, fleet, xf), x0
    if model == "bike_custom":
        fleet = dtt.homogeneous_fleet(user_bike_class()(DT).spec, n, DT)
        return fleet, game_cost(s, fleet, padded(fleet, xf)), padded(fleet, x0)
    raise ValueError(f"unknown closed-loop model {model!r}")


def grid_problem(s, n):
    """``bench.py``'s cold decomposed problem: n Unicycle4D on
    ``grid_scenario``."""
    x0, xf = grid_scenario(n, seed=s.seed)
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, DT)
    return fleet, game_cost(s, fleet, xf), x0


def quad_problem(s, model, n, spacing):
    """``bench.py``'s quadrotor swarm: n of ``model`` on
    ``grid3d_scenario``, n_pos 3."""
    fleet = dtt.homogeneous_fleet(model, n, DT)
    x0, xf = grid3d_scenario(n, spacing=spacing, nx=fleet.nx_p, seed=s.seed)
    return fleet, game_cost(s, fleet, xf, n_pos=3), x0


def hetero_problem(s, n):
    """``bench.py``'s ``hetero_99``: DoubleInt4D, Car3D and Bike5D in turn
    on the swap scenario (spacing 0.75), zero-padded states."""
    x0, xf = swap_scenario(n, spacing=0.75, seed=s.seed)
    fleet = dtt.Fleet(tuple([dtt.DOUBLE_INT_4D, dtt.CAR_3D, dtt.BIKE_5D] * (n // 3)), DT)
    return fleet, game_cost(s, fleet, padded(fleet, xf)), padded(fleet, x0)


def centralized_problem(s, n=10):
    """``bench.py``'s 10-agent centralized problem: ``random_setup(n, 4,
    energy 10)`` from seed 12345."""
    rng = np.random.default_rng(12345 + s.seed)
    x0, xf = dtt.random_setup(n, 4, rng=rng, energy=10.0, n_d=2)
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, DT)
    return fleet, game_cost(s, fleet, xf), x0


# --- Timing, launches and quality. ---------------------------------------

def sync(s):
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)


def counted(s, fn):
    """``fn()`` and each kernel's launches in it (``K1``..``K8``; none on
    the CPU, where the wrappers run the plain versions)."""
    sync(s)
    before = dict(cuda_build.launch_counts)
    out = fn()
    sync(s)
    return out, {KERNEL_IDS[k]: n - before[k] for k, n in cuda_build.launch_counts.items()
                 if n > before[k]}


def timed(s, fn):
    """One warm-up call of ``fn`` (its launches counted), then ``s.reps``
    calls, each between device syncs on the host clock: ``(ms of each
    call, the last call's result, the warm-up's launches)``."""
    out, launches = counted(s, fn)
    ms = []
    for _ in range(s.reps):
        sync(s)
        t0 = perf_counter()
        out = fn()
        sync(s)
        ms.append((perf_counter() - t0) * 1e3)
    return ms, out, launches


def spread(key, ms, hz=None):
    """``key`` (the median of ``ms``), ``key_min``, ``key_max`` and, under
    ``hz``, the median's rate."""
    med = float(np.median(ms))
    out = {key: med, f"{key}_min": float(min(ms)), f"{key}_max": float(max(ms))}
    if hz:
        out[hz] = 1000.0 / med
    return out


def tagged(tag, suffixes, values):
    """``{f"{suffix}_{tag}": value}`` over ``suffixes`` and ``values``."""
    return {f"{k}_{tag}": v for k, v in zip(suffixes, values, strict=True)}


def backward_kernel(launches):
    """The backward kernel(s) a run launched, or ``twin``."""
    ran = [k for k in ("K1", "K3", "K5") if launches.get(k)]
    return "+".join(ran) if ran else "twin"


def quality(tag, iters, converged, J, max_nbhd):
    """A decomposed point's ``QUALITY`` keys under ``tag``."""
    iters = np.asarray(iters)
    mean = float(iters.mean())
    conv = np.asarray(converged, dtype=np.float64)
    return tagged(tag, QUALITY, (float(conv.mean()), float(J), int(iters.sum()), mean,
                                 int(max_nbhd), mean <= 1.0))


def path_keys(tag, backend, launches):
    """The ``PATH`` keys under ``tag``: the backend, the backward kernel
    that ran and each kernel's launches (of one warm-up run)."""
    return tagged(tag, PATH, (backend, backward_kernel(launches), launches))


def backend_of(s):
    """The batched sweep backend a solve on the setting's device takes
    (``DPILQR_SWEEP_BACKEND`` first)."""
    return resolve_backend("auto", torch.empty(0, device=s.device))


def cold_solve(s, fleet, cost, x0, K, U0=None):
    """One ``solve_distributed`` from rest (or from ``U0``) with ``K``
    pinned: ``bench.py``'s ``_distributed_point``."""
    N, n = s.horizon, fleet.n_agents
    X0 = torch.as_tensor(x0, dtype=s.dtype, device=s.device)[None].expand(N + 1, -1, -1)
    if U0 is None:
        U0 = torch.zeros((N, n, fleet.nu_p), dtype=s.dtype, device=s.device)
    return dtt.solve_distributed(fleet, cost, X0, U0, RADIUS, K=K, config=s.config())


def warmstarted_solve(s, fleet, cost, x0, K):
    """``selfish_warmstart`` and the coupled solve from its controls
    (``bench.py`` ``_ws_points``)."""
    x0_t = torch.as_tensor(x0, dtype=s.dtype, device=s.device)
    Uw = dtt.selfish_warmstart(fleet, cost, x0_t, s.horizon, config=s.config())
    return cold_solve(s, fleet, cost, x0, K, U0=Uw)


def decomposed_point(s, time_key, tag, problem, K, hz=None, solve=cold_solve):
    """Time ``solve`` on ``problem``; fail where a neighbourhood outgrew
    ``K``; the spread and the quality keys."""
    fleet, cost, x0 = problem
    ms, res, launches = timed(s, lambda: solve(s, fleet, cost, x0, K))
    if bool(res.truncated):
        raise RuntimeError(f"{tag}: a neighbourhood outgrew K={K} "
                           f"(largest {int(res.sizes.max())}): the point is invalid")
    return res, {
        **spread(time_key, ms, hz),
        **quality(tag, res.iters.cpu(), res.converged.cpu(), res.J, res.sizes.max()),
        **path_keys(tag, backend_of(s), launches),
    }


# --- Points. --------------------------------------------------------------

def distributed_point(s, n):
    """``bench.py``'s cold solve at n agents, K = 8."""
    tag = f"{n}_distributed"
    _, out = decomposed_point(s, f"ms_{tag}", tag, grid_problem(s, s.agents(n)),
                              K_SLOTS, hz=f"hz_{tag}")
    if n == 100:
        # The north-star counter: Riccati block entries a second over the
        # backward sweeps the solve ran.
        nnz = riccati_block_nnz(n_agents=K_SLOTS, nx=4, nu=2, N=s.horizon)
        out["riccati_block_nnz_per_s"] = (nnz * out[f"iters_{tag}"]
                                          / (out[f"ms_{tag}"] / 1e3))
    return out


def mpc_loop(s, fleet, cost, x0, n_steps, K=None, t_kill=None):
    """A function that runs one closed loop of ``n_steps`` receding-horizon
    MPC steps of the decomposed solve (``bench.py``'s ``solve_rhc`` call)."""
    x0, cfg = x0.astype(s.np_dtype), s.config()
    return lambda: dtt.solve_rhc(
        fleet, cost, x0, s.horizon, radius=RADIUS, centralized=False, step_size=1,
        J_converge=1e-3, t_diverge=(n_steps - 1) * DT, K=K, config=cfg,
        rng=np.random.default_rng(s.seed), t_kill=t_kill, device=s.device,
    )


def closed_loop_run(s, n=100, n_steps=20, K=None, model="unicycle", t_kill=None):
    """Sustained closed loop (``bench.py`` ``closed_loop_run``): ``n_steps``
    receding-horizon MPC steps of the decomposed solve.  Under ``t_kill``
    the deadline path's widths are warmed without the deadline first.
    Returns ``(ms per step of each timed loop, over its own steps; the last
    loop's RhcResult; the warm-up loop's launches)``."""
    fleet, cost, x0 = cl_problem(s, n, model)
    if t_kill is not None:
        N = s.horizon
        X0 = torch.as_tensor(x0, dtype=s.dtype, device=s.device)[None].expand(N + 1, -1, -1)
        U0 = torch.zeros((N, n, fleet.nu_p), dtype=s.dtype, device=s.device)
        dtt.solve_distributed_steppable(fleet, cost, X0, U0, RADIUS, K=K,
                                        config=s.config(), t_kill=None)
    run, steps = mpc_loop(s, fleet, cost, x0, n_steps, K, t_kill), []

    def loop():
        # A loop may stop early (J_converge) or, under t_kill, take another
        # path: each loop's steps, the warm-up's first.
        res = run()
        steps.append(len(res.steps))
        return res

    ms, res, launches = timed(s, loop)
    return [t / k for t, k in zip(ms, steps[1:], strict=True)], res, launches


def loop_quality(s, tag, res, launches):
    """A closed loop's quality keys: per-subproblem iterations and flags of
    every step, the executed joint cost, the largest neighbourhood and the
    K of each step."""
    iters = np.concatenate([np.asarray(st.iters) for st in res.steps])
    conv = np.concatenate([np.asarray(st.converged) for st in res.steps])
    return {**quality(tag, iters, conv, res.J, max(st.k_max for st in res.steps)),
            f"K_{tag}": [st.K for st in res.steps], f"steps_{tag}": len(res.steps),
            **path_keys(tag, backend_of(s), launches)}


def mpc_point(s, name, n, n_steps, K, model="unicycle", t_kill=None, traced=False):
    """One of ``bench.py``'s ``_cl_point``s; ``traced`` adds the device's
    busy share on the card (``device_busy``)."""
    ms, res, launches = closed_loop_run(s, s.agents(n), s.steps(n_steps), K, model, t_kill)
    mx = max(st.k_max for st in res.steps)
    if K is not None and mx > K:
        raise RuntimeError(f"mpc_{name} truncated: largest neighbourhood {mx} > K={K}")
    out = {**spread(f"ms_per_mpc_step_{name}", ms, f"hz_mpc_{name}"),
           **loop_quality(s, f"mpc_{name}", res, launches)}
    if t_kill is not None:
        # The reference's real-time contract: how often the deadline binds,
        # the longest solve, and what a host sync costs an iteration.
        out[f"deadline_capped_frac_{name}"] = float(
            np.mean([st.solve_time > t_kill for st in res.steps]))
        out[f"max_solve_ms_{name}"] = max(st.solve_time for st in res.steps) * 1e3
        out[f"host_sync_us_{name}"] = host_sync_us(s.device)
    if traced and s.device.type == "cuda":
        out.update(device_busy(s, s.agents(n), s.steps(n_steps)))
    return out


def host_sync_us(device, n=200):
    """Microseconds of the batched solve's per-iteration host sync (the
    fetch of an active count, ``int(active.sum())``) on an idle device."""
    active = torch.ones(128, dtype=torch.bool, device=device)
    int(active.sum())
    t0 = perf_counter()
    for _ in range(n):
        int(active.sum())
    return (perf_counter() - t0) / n * 1e6


def device_busy(s, n, n_steps):
    """``device_busy_frac_mpc_100``: one more ``mpc_100`` loop, traced in a
    child process (a second ``torch.profiler`` session in one process
    misses the kernels of the ctypes-loaded library)."""
    arg = json.dumps({"device": str(s.device), "dtype": str(s.dtype)[6:], "seed": s.seed,
                      "horizon": s.horizon, "n": n, "n_steps": n_steps})
    child = subprocess.run(
        [sys.executable, "-c", f"import bench_torch as b; b.traced_loop({arg!r})"],
        capture_output=True, text=True, timeout=900, cwd=REPO)
    if child.returncode != 0:
        raise RuntimeError(f"the traced loop failed:\n{child.stderr[-3000:]}")
    return json.loads(child.stdout.strip().splitlines()[-1])


def union_length(spans):
    """The length of the union of ``(start, end)`` intervals (a stream's
    kernels and copies may overlap those of another)."""
    busy, end = 0.0, -np.inf
    for a0, a1 in sorted(spans):
        if a1 > end:
            busy += a1 - max(a0, end)
            end = a1
    return busy


def traced_loop(arg):
    """The child of ``device_busy``: a warm-up loop, then one loop inside
    ``utils.profiling.trace``; prints the device's busy share (the union of
    the CUDA kernels' and copies' intervals over the loop's wall time) and
    its busy milliseconds a step."""
    a = json.loads(arg)
    s = Setting(device=torch.device(a["device"]), dtype=getattr(torch, a["dtype"]),
                seed=a["seed"], horizon=a["horizon"])
    loop = mpc_loop(s, *cl_problem(s, a["n"]), a["n_steps"])
    loop()
    with tempfile.TemporaryDirectory(prefix="bench_torch_trace_") as logdir:
        with trace(logdir) as prof:
            sync(s)
            t0 = perf_counter()
            res = loop()
            sync(s)
            wall_us = (perf_counter() - t0) * 1e6
    # Kernels and copies; not the program's spans, which the profiler also
    # projects onto the device's timeline.
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy, steps = union_length(spans), len(res.steps)
    print(json.dumps(tagged("mpc_100", BUSY, (busy / wall_us, busy / 1e3 / steps,
                                               wall_us / 1e3 / steps, len(spans)))))


def centralized_point(s):
    """``bench.py``'s 10-agent centralized solve (``tol = 1e-9``)."""
    fleet, cost, x0, x0_t, solve = centralized_solver(s)
    n = fleet.n_agents
    U0 = torch.zeros((s.horizon, n, 2), dtype=s.dtype, device=s.device)
    ms, res, launches = timed(s, lambda: solve(cost, x0_t, U0))
    tag = "10_centralized"
    backend = resolve_sweep_backend(s.config(tol=1e-9), x0_t, fleet)
    return {**spread(f"ms_{tag}", ms, f"hz_{tag}"),
            **tagged(tag, CENTRALIZED, (int(res.iters), float(res.J), bool(res.converged))),
            **path_keys(tag, backend, launches)}


def centralized_solver(s):
    """The centralized problem and ``make_solver``'s solve for it:
    ``(fleet, cost, x0, x0 tensor, solve)``."""
    fleet, cost, x0 = centralized_problem(s, s.agents(10))
    solve = dtt.make_solver(fleet, s.horizon, s.config(tol=1e-9))
    return fleet, cost, x0, torch.as_tensor(x0, dtype=s.dtype, device=s.device), solve


def baseline_point(s):
    """The reference algorithm (the numpy oracle of ``tests/oracle.py``)
    solving one K-slot subproblem: its ms an iteration, host only."""
    spec = importlib.util.spec_from_file_location("oracle", REPO / "tests" / "oracle.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    K = K_SLOTS
    x0o, xfo = grid_scenario(K, seed=1 + s.seed)
    model = oracle.OracleMultiModel("Unicycle4D", K, DT)
    cost = oracle.OracleGameCost(xfo.flatten(), [np.eye(4)] * K, [np.eye(2)] * K,
                                 [1e3 * np.eye(4)] * K, RADIUS, 4, 2, K)
    ms, res, _ = timed(s, lambda: oracle.oracle_ilqr(model, cost, x0o.flatten(),
                                                     N=s.horizon, n_lqr_iter=10, tol=1e-9))
    iters = max(res[3], 1)
    return {**spread("baseline_per_iter_ms", [t / iters for t in ms]),
            "baseline_iters": int(res[3])}


def ws_point(s, n):
    """``bench.py``'s selfish-warm-started solve at n agents, timed end to
    end, with its joint cost over the cold solve's."""
    tag = f"{n}_distributed_ws"
    problem = grid_problem(s, s.agents(n))
    res, out = decomposed_point(s, f"ms_{tag}", tag, problem, K_SLOTS, hz=f"hz_{tag}",
                                solve=warmstarted_solve)
    cold = cold_solve(s, *problem, K_SLOTS)
    out[f"J_ws_over_cold_{n}"] = float(res.J) / float(cold.J)
    return out


def family_point(s, name):
    """``bench.py``'s ``_model_family_points``: the Quad6D and Quad12D
    swarms and the mixed fleet, each at its spacing and K."""
    if name == "hetero_99":
        n = s.agents(99, multiple=3)
        problem, K = hetero_problem(s, n), K_SLOTS
    else:
        model, n, spacing, K = {
            "quad6d_64": (dtt.QUAD_6D, 64, 0.85, 8),
            "quad12d_16": (dtt.QUAD_12D, 16, 0.85, 8),
            "quad12d_64": (dtt.QUAD_12D, 64, 1.25, 4),
            "quad12d_64_k8": (dtt.QUAD_12D, 64, 0.85, 8),
        }[name]
        problem = quad_problem(s, model, s.agents(n), spacing)
    return decomposed_point(s, f"ms_{name}_distributed", name, problem, K,
                            hz=f"hz_{name}_distributed")[1]


def sol_point(s):
    """``utils.sol.sol_report`` (card only), under ``bench.py``'s
    ``_sol_extras`` keys (``vpu_`` and ``mxu_`` named for the card's units)."""
    rep = sol.sol_report(s.device)
    k1, k2, ceil, ps = rep["kernels"]["K1"], rep["kernels"]["K2"], rep["ceilings"], rep["pscan"]
    out = {
        "backward_sol_frac": k1["sol_frac"], "backward_gflop_s": k1["achieved_gflop_s"],
        "backward_bound": k1["binding_limit"],
        "forward_sol_frac": k2["sol_frac"], "forward_gflop_s": k2["achieved_gflop_s"],
        "forward_bound": k2["binding_limit"],
        "forward_trig_ceiling_gops_s": k2.get("ceiling_trig_gops_s"),
        "forward_trig_time_frac": k2.get("trig_time_frac_of_sol"),
        "fma_ceiling_gflop_s": ceil["fma_gflop_s"], "hbm_ceiling_gb_s": ceil["hbm_gb_s"],
        "sin_ceiling_gops_s": ceil["sin_gops_s"],
        "matmul_ceiling_gflop_s": ceil["matmul_1024_gflop_s"],
        "pscan_gflop_s": ps["pscan_gflop_s"], "pscan_sol_frac": ps["pscan_sol_frac"],
        "pscan_fair_ceiling_gflop_s": ceil["matmul_batched_gflop_s"],
        "pscan_sol_frac_fair": ps["pscan_sol_frac_fair"],
    }
    for tag, r in rep["kernels"].items():
        key = tag.lower().replace(" ", "_")
        out[f"sol_{key}_ms"] = r["launch_ms"]
        out[f"sol_{key}_published_frac"] = r["published_frac"]
    for probe in ("probe_fma", "probe_hbm", "probe_sin"):
        out[f"sol_{KERNEL_IDS[probe].lower()}_ms"] = rep["probes"][probe].ms
    return out


def trials_point(s, T=8, n=100):
    """8 Monte-Carlo trials of 100 Unicycle4D (swap scenario, spacing 1.25,
    seeds 0-7, warm starts uniform in [0, 0.01)) as one batch of S = T * n
    subproblems at K = 8 (``solve_trials_sharded`` on one device)."""
    n = s.agents(n)
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, DT)
    costs, X_T, U_T = [], [], []
    for t in range(s.seed, s.seed + T):
        x0, xf = swap_scenario(n, 1.25, seed=t)
        costs.append(game_cost(s, fleet, xf))
        X_T.append(x0[None])
        U_T.append(np.random.default_rng(t).uniform(size=(s.horizon, n, 2)) * 0.01)
    cost_T = stack_costs(costs)
    X_T = torch.as_tensor(np.stack(X_T), dtype=s.dtype, device=s.device)
    U_T = torch.as_tensor(np.stack(U_T), dtype=s.dtype, device=s.device)
    mesh = dtt.make_mesh([s.device])
    ms, res, launches = timed(s, lambda: dtt.solve_trials_sharded(
        fleet, cost_T, X_T, U_T, RADIUS, mesh, K_SLOTS, config=s.config()))
    if bool(res.truncated.any()):
        raise RuntimeError(f"trials_8x100: a neighbourhood outgrew K={K_SLOTS}")
    tag = "trials_8x100"
    return {**spread(f"ms_{tag}", ms),
            **quality(tag, res.iters.cpu(), res.converged.cpu(), res.J.sum(),
                      res.sizes.max()),
            **path_keys(tag, backend_of(s), launches)}


def bike_point(s):
    """``mpc_100``'s loop on 100 sympy bicycles (``user_bike_class``)."""
    n = s.agents(100)
    ms, res, launches = closed_loop_run(s, n, s.steps(20), model="bike_custom")
    tag = "mpc_bike_custom_100"
    return {**spread("ms_per_mpc_step_bike_custom_100", ms, "hz_mpc_bike_custom_100"),
            **loop_quality(s, tag, res, launches)}


@dataclasses.dataclass(frozen=True)
class Point:
    run: object  # (Setting) -> dict of keys
    canonical: tuple = ()  # the record's canonical keys this point gives
    timed: tuple = ()  # its timed keys (each with _min and _max)
    tag: str | None = None  # the tag of its quality and PATH keys
    quality: tuple = QUALITY  # its quality keys' suffixes
    kernels: tuple = ("K2", "K4")  # what its own run must launch on the card
    card: tuple = ()  # the suffixes of the keys it adds on the card only


def _cold(n):
    t = f"{n}_distributed"
    return Point(partial(distributed_point, n=n),
                 (f"ms_{t}",) + (("riccati_block_nnz_per_s",) if n == 100 else ()),
                 (f"ms_{t}",), t)


def _mpc(name, n, n_steps, K, canonical=(), **kw):
    key = f"ms_per_mpc_step_{name}"
    return Point(partial(mpc_point, name=name, n=n, n_steps=n_steps, K=K, **kw),
                 (key,) + canonical, (key,), f"mpc_{name}",
                 card=BUSY if kw.get("traced") else ())


def _ws(n):
    key = f"ms_{n}_distributed_ws"
    return Point(partial(ws_point, n=n), (key,) if n == 500 else (), (key,),
                 f"{n}_distributed_ws")


def _family(name):
    key = f"ms_{name}_distributed"
    return Point(partial(family_point, name=name), (key,), (key,), name)


# bench.py's order (its main), then the two cells that bench.py lacks.
POINTS = {
    **{f"distributed_{n}": _cold(n) for n in (50, 100, 250, 500)},
    "mpc_100": _mpc("100", 100, 20, None, traced=True),
    "mpc_250": _mpc("250", 250, 20, 8),
    "mpc_500": _mpc("500", 500, 15, 8),
    "mpc_quad6d_64": _mpc("quad6d_64", 64, 20, None, model="quad6d"),
    "mpc_100_tkill": _mpc("100_tkill", 100, 20, 8, ("deadline_capped_frac_100_tkill",),
                          t_kill=DT),
    "centralized_10": Point(centralized_point, ("ms_10_centralized",),
                            ("ms_10_centralized",), "10_centralized", CENTRALIZED,
                            ("K4", "K5")),
    "baseline": Point(baseline_point, (), ("baseline_per_iter_ms",)),
    **{f"distributed_ws_{n}": _ws(n) for n in (100, 250, 500)},
    **{name: _family(name) for name in ("quad6d_64", "quad12d_16", "quad12d_64",
                                        "quad12d_64_k8", "hetero_99")},
    "sol": Point(sol_point, ("backward_sol_frac", "forward_sol_frac",
                             "forward_trig_time_frac", "pscan_sol_frac_fair")),
    "trials_8x100": Point(trials_point, ("ms_trials_8x100",), ("ms_trials_8x100",),
                          "trials_8x100"),
    "mpc_bike_custom_100": Point(bike_point, ("ms_per_mpc_step_bike_custom_100",),
                                 ("ms_per_mpc_step_bike_custom_100",),
                                 "mpc_bike_custom_100"),
}


def expected_keys(name, s):
    """The keys a point's record must hold when it succeeds on ``s``'s
    device."""
    p = POINTS[name]
    keys = list(p.canonical)
    for k in p.timed:
        keys += [k, f"{k}_min", f"{k}_max"]
    if p.tag is not None:
        card = p.card if s.device.type == "cuda" else ()
        keys += [f"{k}_{p.tag}" for k in p.quality + PATH + card]
    return list(dict.fromkeys(keys))


def card_faults(name, rec):
    """Where a point's record from the card shows that its run left the
    kernels: a backend other than ``cuda``, the plain backward pass, or a
    kernel of its path that its own run never launched.  Empty if none."""
    p = POINTS[name]
    if p.tag is None:
        return []
    backend, backward, launches = (rec.get(f"{k}_{p.tag}") for k in PATH)
    faults = [] if backend == "cuda" else [f"backend {backend}"]
    if backward == "twin":
        faults.append("the plain backward pass ran")
    return faults + [f"{k} never launched" for k in p.kernels if not (launches or {}).get(k)]


def device_record(s):
    """The device's name, the count of cards, and ``nvidia-smi``'s name and
    power limit of the card (None on the CPU or where the call fails)."""
    smi = None
    if s.device.type == "cuda":
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            ).stdout.splitlines()[s.device.index or 0].strip()
        except (OSError, subprocess.SubprocessError, IndexError):
            smi = None
    name = torch.cuda.get_device_name(s.device) if s.device.type == "cuda" else "cpu"
    return {"name": name, "count": torch.cuda.device_count(), "nvidia_smi": smi}


def run_points(s, names, emit=print):
    """Run ``names`` in turn; each point's keys (or its ``<point>_error``)
    and seconds, printed as a JSON line as it finishes.  Returns the keys
    of all of them."""
    extra = {}
    for name in names:
        t0 = perf_counter()
        try:
            keys = POINTS[name].run(s)
        except Exception as e:  # noqa: BLE001 -- a failed point is recorded, the rest run
            traceback.print_exc(file=sys.stderr)
            keys = {f"{name}_error": f"{type(e).__name__}: {e}"[:500]}
        keys[f"seconds_{name}"] = perf_counter() - t0
        emit(json.dumps({"point": name, **keys}))
        sys.stdout.flush()
        extra.update(keys)
    return extra


def record(s, names, extra, wall_s):
    """The last line: ``bench.py``'s record shape over ``extra``."""
    missing = [k for name in names for k in POINTS[name].canonical if extra.get(k) is None]
    if missing:
        extra["incomplete"] = missing
    base_ms = extra.get("baseline_per_iter_ms")
    cold = extra.get("ms_100_distributed")
    vs = None
    if base_ms is not None and cold is not None:
        # The reference runs the n subproblems one after another: its cost
        # is an iteration's time over the 100-agent solve's iterations,
        # scaled by the measured run over this projection (bench.py).
        extra["baseline_100_ms"] = (base_ms * extra["iters_100_distributed"]
                                    * MEASURED_OVER_PROJECTED)
        vs = extra["baseline_100_ms"] / cold
    extra.update(device=device_record(s), dtype=str(s.dtype)[6:], reps=s.reps,
                 seed=s.seed, horizon=s.horizon, points=list(names), wall_s=wall_s,
                 torch=torch.__version__, cuda=torch.version.cuda)
    return {"metric": "dp-ilqr distributed solve, 100 unicycles (K=8 neighborhoods), "
                      f"N={s.horizon}, PyTorch/CUDA port",
            "value": cold, "unit": "ms", "vs_baseline": vs, "extra": extra}


def device_named(name):
    """``"cpu"``, or the card for ``"cuda"`` (``config.default_device``:
    raises without one; TF32 off for the report's matrix products)."""
    if name == "cpu":
        return torch.device("cpu")
    device = default_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--point", action="append", choices=list(POINTS), metavar="NAME",
                    help="a point to run (repeatable; default: all, in bench.py's order)")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--reps", type=int, default=5, help="timed repeats of each point")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="workload seed (0: bench.py's data)")
    ap.add_argument("--list", action="store_true", help="print the point names and exit")
    return ap.parse_args(argv)


def main(argv=None, *, mpc_steps=None, horizon=HORIZON, max_agents=None, emit=print):
    """Run the bench; returns the exit code (1 if a point failed or a
    canonical key is missing).  ``mpc_steps``, ``horizon`` and
    ``max_agents`` cut the points for short runs (``Setting``)."""
    args = parse_args(argv)
    if args.list:
        for name in POINTS:
            emit(name)
        return 0
    s = Setting(device=device_named(args.device), dtype=getattr(torch, args.dtype),
                reps=args.reps, seed=args.seed, horizon=horizon, mpc_steps=mpc_steps,
                max_agents=max_agents)
    names = args.point or list(POINTS)
    t0 = perf_counter()
    extra = run_points(s, names, emit)
    rec = record(s, names, extra, perf_counter() - t0)
    emit(json.dumps(rec))
    failed = [k for k in extra if k.endswith("_error")]
    return 1 if failed or rec["extra"].get("incomplete") else 0


if __name__ == "__main__":
    sys.exit(main())
