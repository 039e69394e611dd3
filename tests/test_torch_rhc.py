"""CPU parity of the port's receding-horizon loop (dpilqr_tpu_torch.
solve_rhc, decomposed mode) with dpilqr_tpu.solve_rhc, float64.

Both loops start from the same scenario and draw their random warm start
from ``np.random.default_rng`` with the same seed, run 3 MPC steps
(``t_diverge``) and must agree on the step count, the per-step J (rtol
1e-8), the graphs and iteration counts, and the executed trajectory (X
atol 1e-7, U atol 1e-6).

``log_fn`` must see one record per committed step with the JAX loop's
fields, and a run checkpointed after step 2 and resumed must equal the
uninterrupted run exactly; a checkpoint written by the JAX package
(``dpilqr_tpu.utils.checkpoint``, the same ``.npz`` layout) loads in the port
and resumes to the same plan (X atol 1e-7, the two packages' agreement).
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
        rng=np.random.default_rng(0), device="cpu", **kw,
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
    kw = dict(radius=RADIUS, centralized=False, J_converge=1e-3, t_diverge=0.0,
              device="cpu")
    # A transposed warm start is refused, not silently reshaped.
    U_T = np.zeros((HORIZON, 2, N_AGENTS))
    with pytest.raises(ValueError, match="U0"):
        dtt.solve_rhc(fleet, cost_t, x0, HORIZON, U0=U_T, **kw)
    with pytest.raises(ValueError):
        dtt.solve_rhc(fleet, cost_t, x0, HORIZON, **kw)  # no U0, no rng
    # The deadline is an argument like any other: no mode refuses it.
    dead = dtt.solve_rhc(fleet, cost_t, x0, HORIZON, t_kill=0.1,
                         rng=np.random.default_rng(0), **kw)
    assert len(dead.steps) == 1 and np.isfinite(dead.J)
    # Centralized mode (the default) runs, with and without a deadline.
    for t_kill in (None, 0.1):
        cent = dtt.solve_rhc(fleet, cost_t, x0, HORIZON, J_converge=1e-3,
                             t_diverge=0.0, t_kill=t_kill,
                             rng=np.random.default_rng(0), device="cpu")
        assert len(cent.steps) == 1 and cent.steps[0].K is None
        assert np.isfinite(cent.J)
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


def _port_run(t_diverge, **kw):
    x0, _, cost_t = _scenario()
    return dtt.solve_rhc(
        dtt.homogeneous_fleet(dtt.UNICYCLE_4D, N_AGENTS, DT), cost_t, x0,
        HORIZON, radius=RADIUS, centralized=False, step_size=1, J_converge=1e-3,
        t_diverge=t_diverge, config=dtt.SolverConfig(n_lqr_iter=8, tol=1e-3),
        rng=np.random.default_rng(0), device="cpu", **kw,
    )


def test_log_fn_sees_every_step_with_the_jax_fields(runs):
    rj, rt = runs
    x0, cost_j, _ = _scenario()
    seen_j, seen_t = [], []
    dtl.solve_rhc(
        dtl.homogeneous_fleet(dtl.UNICYCLE_4D, N_AGENTS, DT), cost_j, x0,
        HORIZON, radius=RADIUS, centralized=False, step_size=1, J_converge=1e-3,
        t_diverge=2 * DT, config=dtl.SolverConfig(n_lqr_iter=8, tol=1e-3),
        rng=np.random.default_rng(0), log_fn=seen_j.append,
    )
    res = _port_run(2 * DT, log_fn=seen_t.append)
    assert len(seen_t) == len(seen_j) == len(res.steps) == 3
    assert all(a is b for a, b in zip(seen_t, res.steps))  # the committed records
    for st, sj in zip(seen_t, seen_j):
        for name in type(sj)._FIELDS:  # t, J, solve_time, graph, iters, distance_left
            assert hasattr(st, name), name
        assert st.t == pytest.approx(sj.t)
        assert st.J == pytest.approx(sj.J, rel=1e-8)
        assert st.graph == sj.graph and st.iters == list(sj.iters)
        assert st.solve_time > 0
        np.testing.assert_allclose(st.distance_left, sj.distance_left, atol=1e-7)
    # Logging changes nothing.
    np.testing.assert_array_equal(res.X, rt.X)


def test_checkpoint_resume_equals_the_uninterrupted_run(tmp_path):
    from dpilqr_tpu_torch.utils.checkpoint import load_rhc_state

    whole = _port_run(3 * DT)
    assert len(whole.steps) == 4
    path = tmp_path / "ckpt" / "rhc.npz"
    first = _port_run(1 * DT, checkpoint_path=path)
    assert len(first.steps) == 2
    state, extra = load_rhc_state(path)
    assert state.step == 2 and extra == {}
    assert state.t == pytest.approx(2 * DT)
    np.testing.assert_array_equal(state.X_full, first.X)
    second = _port_run(3 * DT, resume_state=state)
    assert [s.t for s in second.steps] == pytest.approx([2 * DT, 3 * DT])
    np.testing.assert_array_equal(second.X, whole.X)
    np.testing.assert_array_equal(second.U, whole.U)
    assert second.J == whole.J
    assert [s.iters for s in second.steps] == [s.iters for s in whole.steps[2:]]


def test_checkpoint_written_by_the_jax_package_resumes_in_the_port(tmp_path):
    from dpilqr_tpu_torch.utils.checkpoint import load_rhc_state

    x0, cost_j, _ = _scenario()
    path = tmp_path / "rhc_jax.npz"
    dtl.solve_rhc(
        dtl.homogeneous_fleet(dtl.UNICYCLE_4D, N_AGENTS, DT), cost_j, x0,
        HORIZON, radius=RADIUS, centralized=False, step_size=1, J_converge=1e-3,
        t_diverge=1 * DT, config=dtl.SolverConfig(n_lqr_iter=8, tol=1e-3),
        rng=np.random.default_rng(0), checkpoint_path=path,
    )
    state, _ = load_rhc_state(path)
    assert state.step == 2 and state.X_warm.shape == (HORIZON + 1, N_AGENTS, 4)
    resumed = _port_run(3 * DT, resume_state=state)
    whole = _port_run(3 * DT)
    assert resumed.X.shape == whole.X.shape
    np.testing.assert_allclose(resumed.X, whole.X, atol=1e-7)
    np.testing.assert_allclose(resumed.U, whole.U, atol=1e-6)
    np.testing.assert_allclose(resumed.J, whole.J, rtol=1e-8)
