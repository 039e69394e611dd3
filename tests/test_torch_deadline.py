"""The port's deadline (``t_kill``) solves against the JAX package's, float64
on the CPU.

- ``solve_distributed_steppable(t_kill=None)`` equals the port's
  ``solve_distributed`` exactly (it is the same loop) and the JAX
  ``solve_distributed_steppable`` to X atol 1e-7 with equal iterations and
  flags; with ``t_kill=0`` both return the stitched rollout of the warm
  start after zero iterations.
- Under a clock that the test advances by one second per reading, a
  deadline of k seconds stops the batch after a known number of iterations.
- ``ilqr_solve_steppable`` likewise against ``ilqr_solve`` and the JAX
  function (whose check follows the first iteration, so ``t_kill=0`` runs
  exactly one).
- ``solve_rhc(t_kill=1e9)`` equals ``solve_rhc`` without a deadline in both
  modes, and the JAX loop under the same deadline step for step.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpilqr_tpu as dtl
from dpilqr_tpu.ops.ilqr import ilqr_solve_steppable as steppable_ilqr_j
from dpilqr_tpu.parallel.deadline import (
    solve_distributed_steppable as steppable_j,
)
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy
from dpilqr_tpu_torch.parallel import deadline as deadline_t

torch.set_num_threads(1)

DT, RADIUS = 0.1, 0.5


def _problem(n, N, seed=3, energy=4.0):
    rng = np.random.default_rng(seed)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=energy, n_d=2)
    fleet_j = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, DT)
    cost_j = dtl.make_game_cost(
        xf, np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=RADIUS,
    )
    fleet_t = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, DT)
    cost_t = game_cost_from_numpy(
        {k: np.asarray(v) for k, v in cost_j._asdict().items()}, "cpu", torch.float64)
    U0 = rng.uniform(size=(N, n, 2)) * 0.01
    X0 = np.broadcast_to(np.asarray(x0)[None], (N + 1, n, 4)).copy()
    return fleet_j, cost_j, fleet_t, cost_t, X0, U0


def _assert_same_as_jax(rt, rj):
    np.testing.assert_array_equal(rt.membership.numpy(), np.asarray(rj.membership))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert bool(rt.truncated) == bool(rj.truncated)
    np.testing.assert_allclose(float(rt.J), float(rj.J), rtol=1e-9)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-7)
    np.testing.assert_allclose(rt.U.numpy(), np.asarray(rj.U), atol=1e-6)


@pytest.fixture(scope="module")
def decomposed():
    return _problem(6, 8)


def test_steppable_without_deadline_is_solve_distributed(decomposed):
    fleet_j, cost_j, fleet_t, cost_t, X0, U0 = decomposed
    cfg = dict(n_lqr_iter=6, tol=1e-3)
    Xt, Ut = torch.as_tensor(X0), torch.as_tensor(U0)
    plain = dtt.solve_distributed(fleet_t, cost_t, Xt, Ut, RADIUS,
                                  config=dtt.SolverConfig(**cfg))
    for t_kill in (None, 1e9):
        rt = dtt.solve_distributed_steppable(
            fleet_t, cost_t, Xt, Ut, RADIUS, config=dtt.SolverConfig(**cfg),
            t_kill=t_kill)
        for a, b in zip(rt, plain):
            assert torch.equal(a, b)
    assert int(plain.iters.max()) > 1 and int(plain.sizes.max()) > 1
    rj = steppable_j(fleet_j, cost_j, jnp.asarray(X0), jnp.asarray(U0), RADIUS,
                     config=dtl.SolverConfig(**cfg), t_kill=None)
    _assert_same_as_jax(plain, rj)
    # numpy input and device="cpu": the same solve.
    rn = dtt.solve_distributed_steppable(
        fleet_t, cost_t, X0, U0, RADIUS, config=dtt.SolverConfig(**cfg),
        device="cpu")
    assert torch.equal(rn.X, plain.X)


def test_zero_deadline_returns_the_warm_start_rollout(decomposed):
    fleet_j, cost_j, fleet_t, cost_t, X0, U0 = decomposed
    rt = dtt.solve_distributed(
        fleet_t, cost_t, torch.as_tensor(X0), torch.as_tensor(U0), RADIUS,
        config=dtt.SolverConfig(n_lqr_iter=6), t_kill=0.0)  # forwards
    rj = steppable_j(fleet_j, cost_j, jnp.asarray(X0), jnp.asarray(U0), RADIUS,
                     config=dtl.SolverConfig(n_lqr_iter=6), t_kill=0.0)
    assert int(rt.iters.sum()) == 0 and not bool(rt.converged.any())
    _assert_same_as_jax(rt, rj)
    # The plan is the rollout of the warm-start controls.
    np.testing.assert_allclose(rt.U.numpy(), U0, atol=1e-15)
    X_roll, J_roll = dtt.rollout(fleet_t, cost_t, torch.as_tensor(X0[0]),
                                 torch.as_tensor(U0))
    np.testing.assert_allclose(rt.X.numpy(), X_roll.numpy(), atol=1e-12)
    np.testing.assert_allclose(float(rt.J), float(J_roll), rtol=1e-12)


@pytest.mark.parametrize("budget", [1, 3])
def test_deadline_stops_between_iterations(decomposed, monkeypatch, budget):
    _, _, fleet_t, cost_t, X0, U0 = decomposed
    # One second per reading of the clock: entry reads 0, and the check
    # after the k-th active-count fetch reads k, so a deadline of ``budget``
    # seconds admits exactly ``budget`` iterations.
    ticks = itertools.count()
    monkeypatch.setattr(deadline_t, "perf_counter", lambda: float(next(ticks)))
    monkeypatch.setattr(bt, "perf_counter", lambda: float(next(ticks)))
    cfg = dtt.SolverConfig(n_lqr_iter=6, tol=1e-12)
    rt = dtt.solve_distributed_steppable(
        fleet_t, cost_t, torch.as_tensor(X0), torch.as_tensor(U0), RADIUS,
        config=cfg, t_kill=float(budget))
    full = dtt.solve_distributed(
        fleet_t, cost_t, torch.as_tensor(X0), torch.as_tensor(U0), RADIUS,
        config=dtt.SolverConfig(n_lqr_iter=budget, tol=1e-12))
    assert int(rt.iters.max()) == budget
    # Stopping at the deadline is stopping at the iteration cap: same plan.
    assert torch.equal(rt.iters, full.iters)
    assert torch.equal(rt.X, full.X) and torch.equal(rt.J, full.J)
    assert torch.isfinite(rt.X).all()


def test_ilqr_solve_steppable_matches_jax():
    fleet_j, cost_j, fleet_t, cost_t, X0, U0 = _problem(3, 10, seed=7)
    x0_t, U_t = torch.as_tensor(X0[0]), torch.as_tensor(U0)
    cfg = dict(n_lqr_iter=8)
    plain = dtt.ilqr_solve(fleet_t, cost_t, x0_t, U0=U_t, config=dtt.SolverConfig(**cfg))
    for t_kill in (None, 1e9):
        rt = dtt.ilqr_solve_steppable(fleet_t, cost_t, x0_t, U0=U_t,
                                      config=dtt.SolverConfig(**cfg), t_kill=t_kill)
        for a, b in zip(rt, plain):
            assert torch.equal(a, b)
    rj = steppable_ilqr_j(fleet_j, cost_j, jnp.asarray(X0[0]), U0=jnp.asarray(U0),
                          config=dtl.SolverConfig(**cfg))
    assert int(plain.iters) == int(rj.iters) > 1
    assert bool(plain.converged) == bool(rj.converged)
    np.testing.assert_allclose(float(plain.J), float(rj.J), rtol=1e-9)
    np.testing.assert_allclose(plain.X.numpy(), np.asarray(rj.X), atol=1e-7)
    # A deadline already past: the check follows the first iteration's sync.
    r0 = dtt.ilqr_solve_steppable(fleet_t, cost_t, x0_t, U0=U_t,
                                  config=dtt.SolverConfig(**cfg), t_kill=0.0)
    j0 = steppable_ilqr_j(fleet_j, cost_j, jnp.asarray(X0[0]), U0=jnp.asarray(U0),
                          config=dtl.SolverConfig(**cfg), t_kill=0.0)
    assert int(r0.iters) == int(j0.iters) == 1
    np.testing.assert_allclose(float(r0.J), float(j0.J), rtol=1e-9)
    np.testing.assert_allclose(r0.X.numpy(), np.asarray(j0.X), atol=1e-9)
    # numpy input, device="cpu", N instead of U0.
    rn = dtt.ilqr_solve_steppable(fleet_t, cost_t, X0[0], N=10, device="cpu",
                                  config=dtt.SolverConfig(n_lqr_iter=2), t_kill=1e9)
    assert int(rn.iters) == 2 and rn.X.device.type == "cpu"


@pytest.mark.parametrize("centralized", [True, False], ids=["centralized", "decomposed"])
def test_rhc_under_a_generous_deadline_is_the_same_run(centralized):
    fleet_j, cost_j, fleet_t, cost_t, X0, _ = _problem(6, 10, seed=17)
    kw = dict(radius=None if centralized else RADIUS, centralized=centralized,
              step_size=1, J_converge=1e-3, t_diverge=2 * DT)
    # The scenario and iteration cap of tests/test_torch_rhc.py, where the
    # two loops are known to agree to 1e-8 (capped at 6 iterations the first
    # solve stops unconverged and the packages' rounding shows at 1e-5).
    cfg = dict(n_lqr_iter=8, tol=1e-3)

    def port(t_kill):
        return dtt.solve_rhc(fleet_t, cost_t, X0[0], 10, t_kill=t_kill,
                             config=dtt.SolverConfig(**cfg),
                             rng=np.random.default_rng(0), device="cpu", **kw)

    free, dead = port(None), port(1e9)
    assert len(free.steps) == len(dead.steps) == 3
    np.testing.assert_array_equal(dead.X, free.X)
    np.testing.assert_array_equal(dead.U, free.U)
    assert dead.J == free.J
    assert [s.iters for s in dead.steps] == [s.iters for s in free.steps]
    # The JAX loop under the same deadline (it does not pipeline there).
    rj = dtl.solve_rhc(fleet_j, cost_j, X0[0], 10, t_kill=1e9,
                       config=dtl.SolverConfig(**cfg),
                       rng=np.random.default_rng(0), **kw)
    assert len(rj.steps) == 3
    for st, sj in zip(dead.steps, rj.steps):
        assert st.iters == list(sj.iters)
        assert st.graph == sj.graph
        np.testing.assert_allclose(st.J, sj.J, rtol=1e-8)
    np.testing.assert_allclose(dead.X, rj.X, atol=1e-7)
    np.testing.assert_allclose(dead.J, rj.J, rtol=1e-8)
