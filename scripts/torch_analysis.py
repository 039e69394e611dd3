#!/usr/bin/env python3
"""Monte-Carlo benchmark on the PyTorch/CUDA port: centralized vs
distributed receding-horizon solves on random setups.

Ported from ``scripts/analysis.py`` (the reference's procedure,
scripts/analysis.py:126-174): trials x agent counts x models, paired
centralized/distributed runs from the same initial conditions, CSV rows in
the reference schema (``dpilqr_tpu_torch.utils.metrics``) plus JSON-lines
records, each naming the device that ran it.  Every solve runs in float64
on ``--device`` (default: the card).

Usage:
  python3 scripts/torch_analysis.py                 # full sweep (reference params)
  python3 scripts/torch_analysis.py --quick         # tiny smoke sweep
  python3 scripts/torch_analysis.py --realtime      # mode 2: t_kill = dt cap
  python3 scripts/torch_analysis.py --device cpu    # the kernels' torch twins

``--horizon`` and ``--t-diverge`` shorten a run (defaults: the reference's
N = 50 and 3 N dt, or N dt under ``--realtime``); logs go to ``--logdir``.
"""

import argparse
import os
import sys
from pathlib import Path
from time import strftime

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dpilqr_tpu_torch as dtt  # noqa: E402
from dpilqr_tpu_torch.config import resolve_device  # noqa: E402
from dpilqr_tpu_torch.utils.metrics import (  # noqa: E402
    JsonlWriter,
    csv_row,
    setup_csv_logger,
)

# Reference sweep parameters (analysis.py:128-151).
DT = 0.1
N = 50
ENERGY = 10.0
RADIUS = 0.5
STEP_SIZE = 3

MODELS = {
    "DoubleIntDynamics4D": (dtt.DOUBLE_INT_4D, 4, 2),
    "UnicycleDynamics4D": (dtt.UNICYCLE_4D, 4, 2),
    "QuadcopterDynamics6D": (dtt.QUAD_6D, 6, 3),
}


def build_problem(model_spec, n_states, n_agents, rng, device):
    x0, xf = dtt.random_setup(
        n_agents, n_states, rng=rng, energy=ENERGY, n_d=2,
        rel_dist=2.0, var=n_agents / 2,
    )
    fleet = dtt.homogeneous_fleet(model_spec, n_agents, DT)
    n_controls = fleet.nu_p
    cost = dtt.make_game_cost(
        xf,
        np.tile(np.eye(n_states), (n_agents, 1, 1)),
        np.tile(np.eye(n_controls), (n_agents, 1, 1)),
        np.tile(1e3 * np.eye(n_states), (n_agents, 1, 1)),
        radius=RADIUS,
        n_pos=np.full(n_agents, 2),
        dtype=torch.float64,
        device=device,
    )
    return fleet, cost, x0, xf


def multi_agent_run(
    model_name, n_agents, i_trial, logger, jsonl, rng, device, horizon=N,
    t_kill=None, t_diverge=None,
):
    """Paired centralized/distributed RHC comparison
    (reference analysis.py:35-107)."""
    spec, n_states, _ = MODELS[model_name]
    fleet, cost, x0, xf = build_problem(spec, n_states, n_agents, rng, device)
    ids = list(range(n_agents))
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu")

    results = {}
    for centralized in (True, False):

        def log_step(info, centralized=centralized):
            logger.info(
                csv_row(
                    model_name, n_agents, i_trial, centralized, False,
                    info.t, info.J, horizon, DT, True, ids,
                    [round(info.solve_time, 4)],
                    [info.graph[k] for k in info.graph] if info.graph else [ids],
                    [round(d, 4) for d in info.distance_left],
                )
            )

        res = dtt.solve_rhc(
            fleet, cost, x0, horizon,
            radius=RADIUS, centralized=centralized, step_size=STEP_SIZE,
            dist_converge=0.1, t_diverge=t_diverge or horizon * DT,
            t_kill=t_kill, rng=np.random.default_rng(i_trial),
            log_fn=log_step, device=device,
        )
        tf = res.U.shape[0] * DT
        final_dist = np.linalg.norm(res.X[-1][:, :2] - xf[:, :2], axis=1)
        logger.info(
            csv_row(
                model_name, n_agents, i_trial, centralized, True,
                tf, res.J, horizon, DT, res.converged, ids,
                [round(s.solve_time, 4) for s in res.steps[-1:]],
                [], [round(float(d), 4) for d in final_dist],
            )
        )
        jsonl.write(
            {
                "model": model_name,
                "n_agents": n_agents,
                "trial": i_trial,
                "centralized": centralized,
                "device": device_name,
                "J": res.J,
                "converged": res.converged,
                "tf": tf,
                "mean_solve_time": float(
                    np.mean([s.solve_time for s in res.steps])
                )
                if res.steps
                else None,
                "n_mpc_steps": len(res.steps),
            }
        )
        results[centralized] = res
    return results


def monte_carlo_analysis(args):
    device = resolve_device(args.device)
    logdir = Path(args.logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    mode = 2 if args.realtime else 1
    stamp = strftime("%Y%m%d%H%M%S")
    logger = setup_csv_logger(logdir / f"torch-dec-mc-{mode}_{stamp}.csv")
    jsonl = JsonlWriter(logdir / f"torch-dec-mc-{mode}_{stamp}.jsonl")

    n_trials = 1 if args.quick else 2
    agent_range = [3] if args.quick else [3, 4, 5, 6, 7]
    models = ["DoubleIntDynamics4D"] if args.quick else list(MODELS)
    t_kill = DT if args.realtime else None
    t_diverge = args.t_diverge or (
        args.horizon * DT if args.realtime else 3 * args.horizon * DT)

    rng = np.random.default_rng(args.seed)
    for model_name in models:
        for n_agents in agent_range:
            for trial in range(n_trials):
                print(f"=== {model_name} n={n_agents} trial={trial}")
                multi_agent_run(
                    model_name, n_agents, trial, logger, jsonl, rng, device,
                    horizon=args.horizon, t_kill=t_kill, t_diverge=t_diverge,
                )
    return logdir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny smoke sweep")
    ap.add_argument(
        "--realtime", action="store_true",
        help="mode 2: cap each solve at t_kill = dt (reference analysis.py:145-150)",
    )
    ap.add_argument("--device", default=None,
                    help='torch device of the solves (default: the card; "cpu")')
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=int, default=N)
    ap.add_argument("--t-diverge", type=float, default=None,
                    help="simulated seconds after which a run stops")
    ap.add_argument("--logdir", default="logs")
    monte_carlo_analysis(ap.parse_args(argv))


if __name__ == "__main__":
    main()
