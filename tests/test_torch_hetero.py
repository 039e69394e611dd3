"""The mixed fleet of DoubleInt4D, Car3D and Bike5D agents in turn (the
benchmark's ``hetero_99`` configuration, cut to three triples) against the
benchmark's plain reference (``perfbench/reference``), on the CPU in
float64.

- Bike5D's reference right-hand side and Jacobians against the port's
  ``BIKE_5D`` and forward-mode AD of it;
- one decomposed solve: the gathered inputs exactly, each lane's stopping
  decisions, rollout and cost;
- three steps of the receding-horizon loop: each step's stitched joint cost
  and the executed plan's states and cost against the reference's rollout
  of the same controls, so that Bike5D's single RK4 substep beside the
  others' five is held through the loop.
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.parallel import distributed, rhc
from perfbench.reference import solver as ref

torch.set_num_threads(1)

TRIO = ("DoubleInt4D", "Car3D", "Bike5D")
# The solve's agreement with the reference, as for the float64 mixed fleet
# of perfbench/tests/test_bench_yardstick.py: the stopping decisions exact,
# a subproblem's cost to 1e-6 (two right float64 solves part by rounding
# in the last iterations' line search), a cost of given controls to 1e-10.
J_RTOL, JOINT_RTOL = 1e-6, 1e-10
# The interleaved triples at spacing 0.9 are mostly ill conditioned: on all
# scenario seeds 0-59 but one the reference parts from itself by more than
# 1e-7 in some lane's cost when its warm start moves by 1e-14 (lanes that
# bounce to the iteration cap), so no two right solves agree there.  Seed 7
# is the one where it holds to 1e-7; the test checks that first.
SEED, SELF_GAP = 7, 1e-7


def test_bike5d_reference_dynamics_match_the_port():
    bike = ref.dynamics("Bike5D")
    assert (bike.NX, bike.NU, bike.SUBSTEPS) == (dtt.BIKE_5D.n_x, dtt.BIKE_5D.n_u,
                                                 dtt.BIKE_5D.rk4_substeps)
    g = torch.Generator().manual_seed(5)
    x = torch.rand((64, 5), generator=g, dtype=torch.float64) * 4.0 - 2.0
    x[:, 4] = torch.rand(64, generator=g, dtype=torch.float64) * 2.0 - 1.0  # delta in (-1, 1)
    u = torch.rand((64, 2), generator=g, dtype=torch.float64) * 2.0 - 1.0
    assert torch.allclose(bike.f(x, u), dtt.BIKE_5D.f(x, u), rtol=0, atol=1e-14)
    jac = torch.func.vmap(torch.func.jacfwd(dtt.BIKE_5D.f, argnums=(0, 1)))
    A_ad, B_ad = jac(x, u)
    A, B = bike.jac(x, u)
    assert torch.allclose(A, A_ad, rtol=0, atol=1e-13)
    assert torch.allclose(B, B_ad, rtol=0, atol=1e-13)


class _Fleet:
    """The three triples in turn (``hetero_99`` cut to nine agents, N 20,
    float64): the program's fleet, game cost and settings, and the same
    cost as the reference reads it."""

    def __init__(self):
        self.models = np.array(TRIO * 3)
        self.n, self.N, self.dt, self.radius = len(self.models), 20, 0.1, 0.5
        self.fleet = dtt.Fleet(tuple(dtt.get_model(m) for m in self.models), self.dt)
        self.nx, self.nu = self.fleet.nx_p, self.fleet.nu_p
        self.n_pos = np.full(self.n, 2, np.int32)
        # Q = R = I, Qf = 1e3 I at each agent's own sizes, zero on padding.
        self.Q, self.R, self.Qf = (np.zeros((self.n, d, d)) for d in (self.nx, self.nu, self.nx))
        for i, spec in enumerate(self.fleet.specs):
            self.Q[i, :spec.n_x, :spec.n_x] = np.eye(spec.n_x)
            self.R[i, :spec.n_u, :spec.n_u] = np.eye(spec.n_u)
            self.Qf[i, :spec.n_x, :spec.n_x] = 1e3 * np.eye(spec.n_x)
        self.config = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, n_ls_iter=10, ls_probe=2)

    def scenario(self, seed, spacing=0.9):
        """The swap layout (``bench.py`` ``_swap_scenario``): a jittered
        grid whose adjacent columns swap places."""
        rng = np.random.default_rng(seed)
        n = self.n
        side = int(np.ceil(np.sqrt(n)))
        ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        pts = np.stack([ii, jj], -1).reshape(-1, 2)[:n] * spacing
        pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
        col, i = np.arange(n) % side, np.arange(n)
        partner = np.where((col % 2 == 0) & (col + 1 < side), i + 1,
                           np.where(col % 2 == 1, i - 1, i))
        partner = np.where(partner < n, partner, i)
        goals = pts[partner] + rng.uniform(-0.05, 0.05, pts.shape)
        x0, xf = np.zeros((n, self.nx)), np.zeros((n, self.nx))
        x0[:, :2], xf[:, :2] = pts, goals
        return x0, xf

    def game_cost(self, xf):
        return dtt.make_game_cost(xf, self.Q, self.R, self.Qf, radius=self.radius,
                                  n_pos=self.n_pos, prox_weight=200.0, ref_weight=1.0,
                                  dtype=torch.float64, device="cpu")

    def reference_cost(self, xf) -> dict:
        """The fleet's cost as the reference reads it: one subproblem of n
        slots."""
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64)

        npos = torch.as_tensor(self.n_pos[None], dtype=torch.int32)
        return {"xf": t(xf)[None], "Q": t(self.Q)[None], "R": t(self.R)[None],
                "Qf": t(self.Qf)[None], "n_pos": npos, "n_pos_eval": npos.clone(),
                "mask": t(np.ones((1, self.n))), "radius": t([self.radius]),
                "prox_w": t([200.0]), "ref_w": t([1.0])}


def _joint(p, xf, x0, U):
    """The reference's rollout of ``U (T, n, nu)`` from ``x0 (n, nx)`` and
    its joint cost."""
    X = ref.rollout(p.models, x0[None], U[None], p.dt)
    return X[0], float(ref.trajectory_cost(p.reference_cost(xf), X, U[None])[0])


def test_decomposed_solve_matches_the_reference(monkeypatch):
    p = _Fleet()
    x0, xf = p.scenario(SEED)
    seen = {}
    orig = distributed.solve_subproblems_batched

    def spy(fleet, c, sub_cost, x0_s, U_s, mids_s, enabled, **kw):
        out = orig(fleet, c, sub_cost, x0_s, U_s, mids_s, enabled, **kw)
        seen.update(cost=sub_cost, x0=x0_s, U=U_s, mids=mids_s, out=out)
        return out

    X0 = torch.as_tensor(x0)[None]
    U0 = torch.as_tensor(np.random.default_rng(SEED).uniform(size=(p.N, p.n, p.nu)) * 0.01)
    monkeypatch.setattr(distributed, "solve_subproblems_batched", spy)
    res = dtt.solve_distributed(p.fleet, p.game_cost(xf), X0, U0, p.radius, config=p.config)
    M, _ = ref.interaction_graph(X0, p.radius, p.n_pos)
    assert torch.equal(M, res.membership)
    K = seen["x0"].shape[1]
    assert K > 1  # the neighbourhoods mix models
    idx, mem = ref.gather_plan(M, K)
    fc = {k: (v if k in ("radius", "prox_w", "ref_w") else v[0])
          for k, v in p.reference_cost(xf).items()}
    c, gx0, gU = ref.gather(fc, X0[0], U0, idx, mem)
    assert torch.equal(gx0, seen["x0"]) and torch.equal(gU, seen["U"])
    prog_cost = dict(zip(("xf", "Q", "R", "Qf", "radius", "n_pos", "mask", "prox_w", "ref_w",
                          "n_pos_eval"), seen["cost"]))
    for k, v in c.items():
        assert torch.equal(prog_cost[k].to(v.dtype), v), k
    slots = p.models[idx.numpy()]
    names = np.array([spec.name for spec in p.fleet.unique_specs])
    assert np.array_equal(names[seen["mids"].numpy()], slots)
    assert any(set(row[m]) == set(TRIO) for row, m in zip(slots, mem.numpy()))
    out = ref.solve(slots, c, gx0, gU, p.dt, 15, 1e-3)
    moved = ref.solve(slots, c, gx0, gU * (1.0 + 1e-14), p.dt, 15, 1e-3)
    assert torch.allclose(moved["J"], out["J"], rtol=SELF_GAP)
    prog = seen["out"]
    assert torch.equal(out["iters"], prog.iters)
    assert torch.equal(out["converged"], prog.converged)
    assert torch.equal(out["failed"], prog.failed_line_search)
    assert torch.allclose(out["J"], prog.J, rtol=J_RTOL)
    # Each lane's trajectory is the rollout of its controls, and its cost
    # the cost of that plan.
    X_ref = ref.rollout(slots, gx0, prog.U, p.dt)
    assert torch.allclose(X_ref, prog.X, rtol=0, atol=1e-12)
    assert torch.allclose(ref.trajectory_cost(c, X_ref, prog.U), prog.J, rtol=JOINT_RTOL)
    _, Jj = _joint(p, xf, X0[0], res.U)
    assert Jj == pytest.approx(float(res.J), rel=JOINT_RTOL)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_loop_matches_the_reference(monkeypatch, seed):
    """Three steps of 3 of the decomposed loop: each step's stitched plan
    costed as the reference costs it from the step's start, and the executed
    plan's states and cost.  These compare costs of given controls, which
    the scenarios' conditioning does not touch, so they hold on any seed."""
    p = _Fleet()
    x0, xf = p.scenario(seed)
    cost = p.game_cost(xf)
    steps = []
    orig = rhc.solve_distributed

    def spy(fleet, cost_, X, U, radius, **kw):
        res = orig(fleet, cost_, X, U, radius, **kw)
        steps.append((X[0].clone(), res))
        return res

    monkeypatch.setattr(rhc, "solve_distributed", spy)
    out = dtt.solve_rhc(p.fleet, cost, x0, p.N, radius=p.radius, centralized=False,
                        step_size=3, dist_converge=0.1, n_d=2, t_diverge=0.6,
                        config=p.config, rng=np.random.default_rng(0), device="cpu")
    assert len(out.steps) == 3 and len(steps) >= 3
    for x_start, res in steps:
        _, Jj = _joint(p, xf, x_start, res.U)
        assert Jj == pytest.approx(float(res.J), rel=JOINT_RTOL)
    U = torch.as_tensor(out.U)
    X, J = _joint(p, xf, torch.as_tensor(x0), U)
    assert U.shape[0] == 9
    assert torch.allclose(X[:torch.as_tensor(out.X).shape[0]], torch.as_tensor(out.X),
                          rtol=0, atol=1e-12)
    assert J == pytest.approx(float(out.J), rel=JOINT_RTOL)
