"""CPU parity of the port's receding-horizon loop (dpilqr_tpu_torch.
solve_rhc, decomposed mode) with dpilqr_tpu.solve_rhc, float64.

Both loops start from the same scenario and draw their random warm start
from ``np.random.default_rng`` with the same seed, run 3 MPC steps
(``t_diverge``) and must agree on the step count, the per-step J (rtol
1e-8), the graphs and iteration counts, and the executed trajectory (X
atol 1e-7, U atol 1e-6).
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu as dtl
from dpilqr_tpu.ops.costs import make_game_cost
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy

torch.set_num_threads(1)

N_AGENTS, HORIZON, DT, RADIUS = 6, 10, 0.1, 0.5


def _scenario():
    rng = np.random.default_rng(17)
    x0, xf = dtl.random_setup(N_AGENTS, 4, rng=rng, energy=4.0, n_d=2)
    n = N_AGENTS
    cost_j = make_game_cost(
        xf, np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=RADIUS,
    )
    cost_t = game_cost_from_numpy(
        {k: np.asarray(v) for k, v in cost_j._asdict().items()}, "cpu",
        torch.float64,
    )
    return x0, cost_j, cost_t


@pytest.fixture(scope="module")
def runs():
    x0, cost_j, cost_t = _scenario()
    kw = dict(radius=RADIUS, centralized=False, step_size=1, J_converge=1e-3,
              t_diverge=2 * DT)
    cfg_j = dtl.SolverConfig(n_lqr_iter=8, tol=1e-3)
    rj = dtl.solve_rhc(
        dtl.homogeneous_fleet(dtl.UNICYCLE_4D, N_AGENTS, DT), cost_j, x0,
        HORIZON, config=cfg_j, rng=np.random.default_rng(0), **kw,
    )
    rt = dtt.solve_rhc(
        dtt.homogeneous_fleet(dtt.UNICYCLE_4D, N_AGENTS, DT), cost_t, x0,
        HORIZON, config=dtt.SolverConfig(n_lqr_iter=8, tol=1e-3),
        rng=np.random.default_rng(0), **kw,
    )
    return rj, rt


def test_rhc_steps_and_costs_match_jax(runs):
    rj, rt = runs
    assert len(rt.steps) == len(rj.steps) == 3
    assert rt.converged == rj.converged
    np.testing.assert_allclose(
        [s.J for s in rt.steps], [s.J for s in rj.steps], rtol=1e-8
    )
    for st, sj in zip(rt.steps, rj.steps):
        assert st.t == pytest.approx(sj.t)
        assert st.iters == list(sj.iters)
        assert st.graph == sj.graph
        np.testing.assert_allclose(st.distance_left, sj.distance_left, atol=1e-7)
    # Some coupling is exercised: a step plans agents jointly.
    assert max(s.k_max for s in rt.steps) > 1


def test_rhc_executed_trajectory_matches_jax(runs):
    rj, rt = runs
    assert rt.X.shape == rj.X.shape and rt.U.shape == rj.U.shape
    np.testing.assert_allclose(rt.X, rj.X, atol=1e-7)
    # Controls carry the state difference through the feedback gains
    # (|K| ~ 10 here), so they agree about ten times more loosely.
    np.testing.assert_allclose(rt.U, rj.U, atol=1e-6)
    np.testing.assert_allclose(rt.J, rj.J, rtol=1e-8)


def test_rhc_rejects_bad_arguments():
    x0, _, cost_t = _scenario()
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, N_AGENTS, DT)
    kw = dict(radius=RADIUS, centralized=False, J_converge=1e-3, t_diverge=0.0)
    # A transposed warm start is refused, not silently reshaped.
    U_T = np.zeros((HORIZON, 2, N_AGENTS))
    with pytest.raises(ValueError, match="U0"):
        dtt.solve_rhc(fleet, cost_t, x0, HORIZON, U0=U_T, **kw)
    with pytest.raises(ValueError):
        dtt.solve_rhc(fleet, cost_t, x0, HORIZON, **kw)  # no U0, no rng
    with pytest.raises(NotImplementedError):
        dtt.solve_rhc(fleet, cost_t, x0, HORIZON, t_kill=0.1,
                      rng=np.random.default_rng(0), **kw)
    # Centralized mode (the default) runs; its deadline is not ported.
    cent = dtt.solve_rhc(fleet, cost_t, x0, HORIZON, J_converge=1e-3,
                         t_diverge=0.0, rng=np.random.default_rng(0))
    assert len(cent.steps) == 1 and cent.steps[0].K is None
    assert np.isfinite(cent.J)
    with pytest.raises(NotImplementedError):
        dtt.solve_rhc(fleet, cost_t, x0, HORIZON, J_converge=1e-3,
                      t_kill=0.1, rng=np.random.default_rng(0))
    # A correctly shaped warm start runs.
    res = dtt.solve_rhc(fleet, cost_t, x0, HORIZON,
                        U0=np.zeros((HORIZON, N_AGENTS, 2)), **kw)
    assert len(res.steps) == 1 and np.isfinite(res.J)


def test_selfish_warmstart_matches_jax():
    x0, cost_j, cost_t = _scenario()
    cfg = dict(n_lqr_iter=6, tol=1e-3)
    Uj = dtl.selfish_warmstart(
        dtl.homogeneous_fleet(dtl.UNICYCLE_4D, N_AGENTS, DT), cost_j, x0,
        HORIZON, config=dtl.SolverConfig(**cfg),
    )
    Ut = dtt.selfish_warmstart(
        dtt.homogeneous_fleet(dtt.UNICYCLE_4D, N_AGENTS, DT), cost_t,
        torch.as_tensor(x0), HORIZON, config=dtt.SolverConfig(**cfg),
    )
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=1e-7)
