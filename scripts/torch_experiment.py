#!/usr/bin/env python3
"""Real-time MPC experiment runner on the PyTorch/CUDA port.

Ported from ``scripts/experiment.py`` (capability parity with the
reference's Crazyflie/VICON experiment runner, scripts/experiment.py): a
measurement -> deadline-bounded solve -> actuate loop with adaptive horizon,
warm starting, go-home safety handling and npz result logging.  The solves
run in float64 on ``--device`` (default: the card).  The vehicle layer is
pluggable:

- ``SimulatedVehicles``: propagates the "real" fleet on the host with the
  port's native host dynamics (``dpilqr_tpu_torch/native/bbdyn.cpp``, built
  with g++ on first use; the torch models where it cannot build) plus
  measurement noise -- runnable anywhere.
- A hardware interface would subclass ``VehicleInterface`` with the radio /
  motion-capture stack (the reference's rclpy + crazyflie_py + VICON,
  experiment.py:53-88,281-285).

``--rate`` paces the actuation loop with ``dpilqr_tpu_torch.Rate``.

Usage: python3 scripts/torch_experiment.py [--centralized] [--device cpu]
       [--steps 80] [--rate HZ] [--outdir logs]
"""

import argparse
import atexit
import os
import sys
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dpilqr_tpu_torch as dtt  # noqa: E402
from dpilqr_tpu_torch.config import resolve_device  # noqa: E402
from dpilqr_tpu_torch.native import host as native  # noqa: E402
from dpilqr_tpu_torch.parallel.deadline import (  # noqa: E402
    solve_distributed_steppable,
)

# Reference experiment constants (experiment.py:93-112).
DT = 0.05
N_MIN, N_MAX = 10, 60  # adaptive horizon bounds (experiment.py:111)
STEP_SIZE = 1
RADIUS = 0.5
GOAL_TOL = 0.1


class VehicleInterface:
    """Measurement + actuation boundary (the reference's ROS2/VICON layer)."""

    def measure(self) -> np.ndarray:
        """Current block state (n, nx_p)."""
        raise NotImplementedError

    def actuate(self, U_plan: np.ndarray) -> None:
        """Apply the first planned controls for one period."""
        raise NotImplementedError

    def go_home(self) -> None:
        """Safety callback on exit (reference experiment.py:311-318)."""


class SimulatedVehicles(VehicleInterface):
    """Host-side plant simulation on the native host dynamics, with optional
    measurement noise standing in for motion capture."""

    def __init__(self, fleet: dtt.Fleet, x0, noise=0.0, rng=None):
        self.fleet = fleet
        self.model_ids = [s.model_id for s in fleet.specs]
        self.x = np.asarray(x0, float).copy()
        self.noise = noise
        self.rng = rng or np.random.default_rng(0)
        self._use_native = native.available()

    def measure(self):
        meas = self.x.copy()
        if self.noise:
            meas[:, :2] += self.noise * self.rng.standard_normal(
                meas[:, :2].shape
            )
        return meas

    def actuate(self, U_plan):
        u = np.asarray(U_plan[0], float)
        if self._use_native:
            self.x = native.step(self.model_ids, self.x, u, self.fleet.dt)
        else:
            self.x = self.fleet.step(torch.as_tensor(self.x),
                                     torch.as_tensor(u)).numpy()

    def go_home(self):
        pass


class ExperimentRunner:
    """MPC loop (reference experiment.py:114-308)."""

    def __init__(self, fleet, cost, vehicles: VehicleInterface, xf,
                 centralized=False, ignore_mask=None, outdir="logs",
                 rate_hz=None, device=None):
        self.fleet = fleet
        self.cost = cost
        self.vehicles = vehicles
        self.xf = np.asarray(xf)
        self.centralized = centralized
        self.ignore_mask = ignore_mask
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.device = resolve_device(device)
        # Real-time pacing of the actuation loop (the reference's
        # sleepForRate(GOTO_RATE), experiment.py:260).  None = free-running
        # (simulation / CI).
        self.rate = dtt.Rate(rate_hz) if rate_hz else None
        atexit.register(self.vehicles.go_home)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, float), device=self.device)

    def _adapt_horizon(self, x):
        """Scale N with distance-to-go (reference experiment.py:268-272),
        quantized to buckets of 10 as ``scripts/experiment.py`` does."""
        d = float(
            np.max(np.linalg.norm(x[:, :2] - self.xf[:, :2], axis=1))
        )
        frac = min(d / 3.0, 1.0)
        N = int(N_MIN + frac * (N_MAX - N_MIN))
        return max(N_MIN, min(N_MAX, int(round(N / 10.0)) * 10))

    def _solve(self, x, U, t_kill):
        if self.centralized:
            res = dtt.ilqr_solve_steppable(
                self.fleet, self.cost, self._t(x), U0=self._t(U), t_kill=t_kill,
            )
        else:
            # K pinned at the fleet size: at experiment scale (4 vehicles)
            # truncation is impossible at K = n.
            res = solve_distributed_steppable(
                self.fleet, self.cost, self._t(x)[None], self._t(U), RADIUS,
                ignore_mask=self.ignore_mask, t_kill=t_kill,
                K=self.fleet.n_agents,
            )
        return res.X.cpu().numpy(), res.U.cpu().numpy()

    def prewarm(self, verbose=True):
        """One short solve before the real-time loop: on the card it builds
        the kernels (about a minute on first use), which inside the loop
        would blow the ``t_kill`` deadline.  Nothing compiles per horizon."""
        t0 = perf_counter()
        x = self.vehicles.measure()
        self._solve(x, np.zeros((N_MIN, self.fleet.n_agents, self.fleet.nu_p)), 0.05)
        if verbose:
            print(f"prewarm: {perf_counter() - t0:.1f}s")

    def run(self, max_steps=200, verbose=True, prewarm=True):
        n, nu_p = self.fleet.n_agents, self.fleet.nu_p
        if prewarm:
            self.prewarm(verbose=verbose)
        x = self.vehicles.measure()
        N = self._adapt_horizon(x)
        U = dtt.selfish_warmstart(self.fleet, self.cost, self._t(x), N).cpu().numpy()
        X_hist, U_hist, t_hist = [x.copy()], [], []

        for step in range(max_steps):
            x = self.vehicles.measure()
            d_left = np.linalg.norm(x[:, :2] - self.xf[:, :2], axis=1)
            if np.all(d_left < GOAL_TOL):
                if verbose:
                    print(f"arrived after {step} steps")
                break

            t0 = perf_counter()
            t_kill = N * DT  # reference experiment.py:141-142,220-226
            X_plan, U_plan = self._solve(x, U, t_kill)
            solve_t = perf_counter() - t0

            if self.rate is not None:
                self.rate.sleep()
            self.vehicles.actuate(U_plan)
            X_hist.append(self.vehicles.measure())
            U_hist.append(U_plan[0])
            t_hist.append(solve_t)
            if verbose and step % 10 == 0:
                print(
                    f"step {step}: N={N} solve={solve_t * 1e3:.1f} ms "
                    f"d_left={np.round(d_left, 2).tolist()}"
                )

            # Shift warm start and adapt horizon.
            U = np.concatenate(
                [U_plan[STEP_SIZE:], np.zeros((STEP_SIZE, n, nu_p))]
            )
            N_new = self._adapt_horizon(x)
            if N_new < U.shape[0]:
                U = U[:N_new]
            elif N_new > U.shape[0]:
                U = np.concatenate(
                    [U, np.zeros((N_new - U.shape[0], n, nu_p))]
                )
            N = N_new

        out = self.outdir / "torch_experiment_results.npz"
        np.savez(
            out,
            X=np.stack(X_hist),
            U=np.stack(U_hist) if U_hist else np.zeros((0, n, nu_p)),
            solve_times=np.asarray(t_hist),
            xf=self.xf,
        )
        if verbose:
            print(f"saved {out}")
            if self.rate is not None:
                print(
                    f"rate: {self.rate.hz:.1f} Hz, "
                    f"{self.rate.missed}/{self.rate.ticks} deadlines missed"
                )
        return np.stack(X_hist), t_hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--centralized", action="store_true")
    ap.add_argument("--device", default=None,
                    help='torch device of the solves (default: the card; "cpu")')
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument(
        "--rate", type=float, default=None,
        help="pace the actuation loop at this Hz (reference sleepForRate)",
    )
    ap.add_argument("--outdir", default="logs")
    args = ap.parse_args(argv)

    # 2 quads + 2 linear humans (reference experiment.py:154-184).
    n_q, n_h = 2, 2
    n = n_q + n_h
    fleet = dtt.Fleet(
        (dtt.DOUBLE_INT_6D,) * n_q + (dtt.HUMAN_LIN_6D,) * n_h, DT
    )
    x0 = np.array(
        [
            [-1.5, 0.1, 1, 0, 0, 0],
            [1.5, 0.0, 1, 0, 0, 0],
            [0.0, -1.0, 1.0, 0, 0, 0],
            [0.2, 1.0, 1.0, 0, 0, 0],
        ]
    )
    xf = np.array(
        [
            [1.5, 0.0, 1.5, 0, 0, 0],
            [-1.5, 0.0, 1.5, 0, 0, 0],
            [0.0, 1.5, 1.0, 0, 0, 0],
            [0.2, -1.0, 1.0, 0, 0, 0],
        ]
    )
    cost = dtt.make_game_cost(
        xf,
        np.tile(np.eye(6), (n, 1, 1)),
        np.tile(0.1 * np.eye(3), (n, 1, 1)),
        np.tile(1e3 * np.eye(6), (n, 1, 1)),
        radius=RADIUS,
        n_pos=np.array([3] * n_q + [2] * n_h),
        dtype=torch.float64,
        device=args.device,
    )
    vehicles = SimulatedVehicles(fleet, x0, noise=args.noise)
    runner = ExperimentRunner(
        fleet, cost, vehicles, xf, centralized=args.centralized,
        outdir=args.outdir, rate_hz=args.rate, device=args.device,
    )
    X, times = runner.run(max_steps=args.steps)
    print(
        f"final positions: {np.round(X[-1][:, :3], 2).tolist()}\n"
        f"mean solve: {np.mean(times) * 1e3:.1f} ms, "
        f"max: {np.max(times) * 1e3:.1f} ms"
    )


if __name__ == "__main__":
    main()
