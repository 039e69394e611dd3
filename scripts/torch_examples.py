#!/usr/bin/env python3
"""Demonstration scenarios on the PyTorch/CUDA port (``dpilqr_tpu_torch``),
ported from ``scripts/examples.py`` (capability parity with the reference's
scripts/examples.py):

- single unicycle                   (examples.py:26-46)
- single 6D quadcopter              (examples.py:49-71)
- two quads + one human             (examples.py:74-131)
- random multi-agent simulation     (examples.py:134-199)
- five 3D double-integrators        (examples.py:202-259)
- n quads + m humans, distributed with selfish warm start and ignored
  human subproblems                 (examples.py:262-330)

Every solve runs on ``--device`` (default: the card; ``--device cpu`` runs
the kernels' torch twins) in float64.  Plots show only where matplotlib is
installed and ``--no-plot`` is not given.  Run from anywhere:

    python3 scripts/torch_examples.py [name] [--device cpu] [--no-plot] [--all]
"""

import argparse
import os
import sys

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import dpilqr_tpu_torch as dtt  # noqa: E402
import scenarios  # noqa: E402

G = dtt.GRAVITY
SHOW = True
DEVICE = None


def _show(fig_fn):
    if not SHOW:
        return
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig_fn(plt)
    plt.show()


def _np(t):
    return t.detach().cpu().numpy()


def _x(a):
    """Host numpy as a float64 tensor on the run's device."""
    return torch.as_tensor(np.asarray(a, float), device=dtt.config.resolve_device(DEVICE))


def _cost(xf, Q, R, Qf, **kw):
    return dtt.make_game_cost(xf, Q, R, Qf, dtype=torch.float64, device=DEVICE, **kw)


def single_unicycle():
    dt, N = 0.05, 50
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 1, dt)
    x0 = np.array([[-10.0, 10, 10, 0]])
    xf = np.zeros((1, 4))
    cost = _cost(xf, np.diag([1.0, 1, 0, 0])[None], np.eye(2)[None],
                 (1000 * np.eye(4))[None], radius=0.0)
    res = dtt.ilqr_solve(fleet, cost, _x(x0), N=N)
    print(f"J = {float(res.J):.4f}, converged = {bool(res.converged)}")

    def plot(plt):
        from dpilqr_tpu_torch.utils import viz

        viz.plot_solve(res.X, float(res.J), xf)

    _show(plot)
    return res


def single_quad6d():
    dt, N = 0.1, 40
    fleet = dtt.homogeneous_fleet(dtt.QUAD_6D, 1, dt)
    x0 = np.array([[2.0, 2, 0.5, 0, 0, 0]])
    xf = np.zeros((1, 6))
    cost = _cost(xf, np.eye(6)[None], np.diag([0.0, 1, 1])[None],
                 (100 * np.eye(6))[None], radius=0.0, n_pos=np.array([3]))
    res = dtt.ilqr_solve(fleet, cost, _x(x0), N=N)
    print(f"J = {float(res.J):.4f}, converged = {bool(res.converged)}")

    def plot(plt):
        from dpilqr_tpu_torch.utils import viz

        viz.plot_solve(res.X, float(res.J), xf, n_d=3)

    _show(plot)
    return res


def two_quads_one_human():
    n_agents, n_states = 3, 6
    dt, N, radius = 0.05, 50, 0.3
    x0, xf = scenarios.q2h1_passthrough()

    Q = np.diag([1.0, 1, 1, 5, 5, 5])
    R = np.diag([1.0, 1, 1])
    Qf = 1e3 * np.eye(n_states)
    Q_h = np.diag([1.0, 1, 1, 0, 0, 0])
    R_h = np.diag([1.0, 1, 1e-9])

    fleet = dtt.Fleet((dtt.QUAD_6D, dtt.QUAD_6D, dtt.HUMAN_6D), dt)
    cost = _cost(xf, np.stack([Q, Q, Q_h]), np.stack([R, R, R_h]),
                 np.stack([Qf, Qf, Qf]), radius=radius, n_pos=np.array([3, 3, 2]))
    U0 = np.zeros((N, n_agents, 3))
    U0[:, :2, 0] = G  # hover thrust for the quads
    U0[:, 2, :] = 1.0
    res = dtt.ilqr_solve(fleet, cost, _x(x0), U0=_x(U0))
    print(f"J = {float(res.J):.4f}, converged = {bool(res.converged)}")

    def plot(plt):
        from dpilqr_tpu_torch.utils import viz

        plt.figure()
        viz.plot_solve(res.X, float(res.J), xf, n_d=3)
        plt.figure()
        viz.plot_pairwise_distances(res.X, radius, n_pos=np.array([3, 3, 2]))

    _show(plot)
    return res


def random_multiagent_simulation():
    n_agents, n_states = 7, 4
    dt, N, radius = 0.05, 60, 0.5
    rng = np.random.default_rng(7)
    x0, xf = dtt.random_setup(
        n_agents, n_states, rng=rng, rel_dist=2.0, var=n_agents / 2,
        n_d=2, random=True,
    )
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n_agents, dt)
    cost = _cost(xf, np.tile(np.eye(4), (n_agents, 1, 1)),
                 np.tile(np.eye(2), (n_agents, 1, 1)),
                 np.tile(1e3 * np.eye(4), (n_agents, 1, 1)), radius=radius)
    res = dtt.ilqr_solve(fleet, cost, _x(x0), N=N, config=dtt.SolverConfig(tol=1e-6))
    print(f"J = {float(res.J):.4f}, converged = {bool(res.converged)}")

    def plot(plt):
        from dpilqr_tpu_torch.utils import viz

        viz.eyeball_scenario(x0, xf)
        plt.figure()
        viz.plot_solve(res.X, float(res.J), xf)
        plt.figure()
        viz.plot_pairwise_distances(res.X, radius)

    _show(plot)
    return res


def _3d_integrators():
    n_agents = 5
    dt, N, radius = 0.05, 60, 0.6
    x0, xf = scenarios.five_quads_figure1()
    fleet = dtt.homogeneous_fleet(dtt.DOUBLE_INT_6D, n_agents, dt)
    cost = _cost(xf, np.tile(np.eye(6), (n_agents, 1, 1)),
                 np.tile(np.eye(3), (n_agents, 1, 1)),
                 np.tile(1e3 * np.eye(6), (n_agents, 1, 1)), radius=radius,
                 n_pos=np.full(n_agents, 3))
    res = dtt.ilqr_solve(fleet, cost, _x(x0), N=N)
    print(f"J = {float(res.J):.4f}, converged = {bool(res.converged)}")

    def plot(plt):
        from dpilqr_tpu_torch.utils import viz

        viz.plot_solve(res.X, float(res.J), xf, n_d=3)
        plt.gca().set_zlim([0, 2])
        plt.figure()
        viz.plot_pairwise_distances(res.X, radius, n_pos=np.full(n_agents, 3))

    _show(plot)
    return res


def nquads_mhumans():
    n_q, n_h = 2, 2
    n_agents = n_q + n_h
    dt, N, radius = 0.05, 60, 1.0
    x0, xf = scenarios.q2h2_hcross()

    Q = np.eye(6)
    R = 0.1 * np.eye(3)
    Qf = 1e4 * np.eye(6)
    fleet = dtt.Fleet((dtt.QUAD_6D,) * n_q + (dtt.HUMAN_LIN_6D,) * n_h, dt)
    cost = _cost(xf, np.tile(Q, (n_agents, 1, 1)), np.tile(R, (n_agents, 1, 1)),
                 np.tile(Qf, (n_agents, 1, 1)), radius=radius,
                 n_pos=np.array([3, 3, 2, 2]))

    U0 = dtt.selfish_warmstart(fleet, cost, _x(x0), N)
    ignore = np.array([False] * n_q + [True] * n_h)
    res = dtt.solve_distributed(fleet, cost, _x(x0)[None], U0, radius,
                                ignore_mask=ignore)
    graph = dtt.graph_to_dict(res.membership)
    print(f"J = {float(res.J):.4f}; graph = {graph}")

    def plot(plt):
        from dpilqr_tpu_torch.utils import viz

        viz.plot_interaction_graph(graph)
        plt.figure()
        viz.plot_solve(res.X, float(res.J), xf, n_d=3)
        plt.figure()
        viz.plot_pairwise_distances(res.X, radius, n_pos=np.array([3, 3, 2, 2]))

    _show(plot)
    return res


EXAMPLES = {
    "single_unicycle": single_unicycle,
    "single_quad6d": single_quad6d,
    "two_quads_one_human": two_quads_one_human,
    "random_multiagent_simulation": random_multiagent_simulation,
    "3d_integrators": _3d_integrators,
    "nquads_mhumans": nquads_mhumans,
}


def main(argv=None):
    global SHOW, DEVICE
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="nquads_mhumans",
                    choices=sorted(EXAMPLES))
    ap.add_argument("--device", default=None,
                    help='torch device of the solves (default: the card; "cpu")')
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    DEVICE = args.device
    if args.no_plot:
        SHOW = False
    if args.all:
        for name, fn in EXAMPLES.items():
            print(f"--- {name}")
            fn()
    else:
        EXAMPLES[args.name]()


if __name__ == "__main__":
    main()
