"""Parity of the port's centralized solve with the JAX package, float64.

The port's plain PyTorch sweeps (``dpilqr_tpu_torch.ops.ilqr``
``_backward_pass``, ``_forward_pass``, ``_rollout_fn``: the twins of the
kernels ``csrc/backward_sweep.cu`` and ``csrc/forward_sweep.cu``) are held
against the JAX package's Pallas sweeps in interpret mode and its XLA
sweeps, rtol 1e-10 relative to max|.|, on the cases of
``tests/test_pallas.py``.  ``ilqr_solve`` is held against the JAX
``ilqr_solve`` on the ``tests/test_ilqr.py`` scenarios (equal iterations,
converged and failed flags; J rtol 1e-9; X and U to rtol 1e-9 of their
largest entry, except where the scenario itself is less well conditioned,
see ``SCENARIOS``) and against ``tests/oracle.py``;
``solve_rhc(centralized=True)`` against the JAX loop for 3 MPC steps.
The kernels themselves are held against these twins on a card by
``tests/test_torch_sweeps.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpilqr_tpu as dtl
from dpilqr_tpu.ops import ilqr as I
from dpilqr_tpu.ops.pallas_sweeps import (
    backward_pass_pallas,
    forward_pass_pallas,
    rollout_pallas,
)
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import ilqr as It
from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy

from oracle import OracleGameCost, OracleMultiModel, oracle_ilqr

torch.set_num_threads(1)

RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _port_cost(cost):
    return game_cost_from_numpy(
        {k: np.asarray(v) for k, v in cost._asdict().items()}, "cpu", torch.float64
    )


def _port_fleet(fleet):
    return dtt.Fleet.from_names([s.name for s in fleet.specs], fleet.dt)


def _setup(case, N=12):
    """The cases of tests/test_pallas.py in float64, packed (energy 1
    instead of 8) so that agents start inside each other's radius: JAX
    fleet, cost, x0, U0 (numpy)."""
    if case == "single_agent":
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 1, 0.1)
        cost = dtl.make_game_cost(np.zeros((1, 4)), np.eye(4)[None], np.eye(2)[None],
                                  1e2 * np.eye(4)[None], radius=0.0)
        x0 = np.array([[1.0, 1, 0.5, 0]])
        U0 = 0.1 * np.random.default_rng(0).normal(size=(8, 1, 2))
        return fleet, cost, x0, U0
    n = 4
    rng = np.random.default_rng(1)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=1.0)
    if case == "heterogeneous":
        fleet = dtl.Fleet((dtl.UNICYCLE_4D, dtl.DOUBLE_INT_4D) * (n // 2), 0.1)
    else:
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    cost = dtl.make_game_cost(
        xf, np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=0.5,
    )
    U0 = rng.normal(size=(N, n, 2)) * 0.1
    return fleet, cost, x0, U0


def _nominal(fleet, cost, x0, U0):
    X0, _ = I._rollout_fn(fleet.step, cost, jnp.asarray(x0), jnp.asarray(U0))
    return np.array(X0)


# Hover controls (slot, value) of the models that fall without them.
_HOVER = {"Quad6D": (0, 9.80665), "Quad12D": (3, 9.80665 * 63 / 2000)}


def _model_setup(names, N=5):
    """Three agents of one model (or a mixed fleet) packed inside each
    other's radius, each with its own position size, about hover where the
    model falls (Quad12D's torques stay at 1e-7: its gains are ~6e4): JAX
    fleet, cost, x0, U0 (numpy)."""
    fleet = dtl.Fleet(tuple(names), 0.1)
    n, nx, nu = fleet.n_agents, fleet.nx_p, fleet.nu_p
    rng = np.random.default_rng(n + 17 * len(set(names)))
    x0 = np.zeros((n, nx))
    x0[:, :3] = rng.uniform(-0.25, 0.25, (n, 3))[:, :min(3, nx)]
    xf = -x0
    cost = dtl.make_game_cost(
        xf, np.tile(np.eye(nx), (n, 1, 1)), np.tile(np.eye(nu), (n, 1, 1)),
        np.tile(1e2 * np.eye(nx), (n, 1, 1)), radius=0.5,
        n_pos=np.array([s.n_pos for s in fleet.specs], np.int32))
    U0 = 0.05 * rng.normal(size=(N, n, nu)) * np.asarray(fleet.control_mask)
    for i, spec in enumerate(fleet.specs):
        if spec.name == "Quad12D":
            U0[:, i] *= 2e-6
        if spec.name in _HOVER:
            U0[:, i, _HOVER[spec.name][0]] += _HOVER[spec.name][1]
    return fleet, cost, x0, U0


BACKWARD_CASES = {s.name: [s.name] * 3 for s in dtl.MODEL_REGISTRY}
BACKWARD_CASES["mixed"] = [s.name for s in dtl.MODEL_REGISTRY]


@pytest.mark.parametrize("case", ["homogeneous", *BACKWARD_CASES])
def test_backward_twin_matches_jax(case):
    """K5's twin against the JAX package's Pallas sweep in interpret mode
    (and, on the Unicycle4D swap of tests/test_pallas.py, its XLA sweep):
    the swap, three agents of each of the nine models, and one agent of each
    (padded to nx_p 12: every Jacobian in one fleet)."""
    if case == "homogeneous":
        fleet, cost, x0, U0 = _setup("homogeneous")
        X0 = _nominal(fleet, cost, x0, U0)
    else:  # the nominal from the port's rollout: the JAX one compiles per fleet
        fleet, cost, x0, U0 = _model_setup(BACKWARD_CASES[case])
        X0 = It._rollout_fn(_port_fleet(fleet).step, _port_cost(cost),
                            torch.as_tensor(x0), torch.as_tensor(U0))[0].numpy()
    # Precondition: proximity pairs are active along the nominal.
    assert float(dtt.proximity_cost(_port_cost(cost), torch.as_tensor(X0)).max()) > 0
    K_p, d_p = backward_pass_pallas(fleet, cost, jnp.asarray(X0), jnp.asarray(U0),
                                    jnp.float64(1.0), interpret=True)
    K_t, d_t = It._backward_pass(_port_fleet(fleet).linearize, _port_cost(cost),
                                 torch.as_tensor(X0), torch.as_tensor(U0),
                                 torch.tensor(1.0, dtype=torch.float64))
    pairs = [(K_t, K_p), (d_t, d_p)]
    if case == "homogeneous":
        K_x, d_x = I._backward_pass(fleet.linearize, cost, jnp.asarray(X0),
                                    jnp.asarray(U0), jnp.float64(1.0))
        pairs += [(K_t, K_x), (d_t, d_x)]
    for got, want in pairs:
        _close(got, want)


@pytest.mark.parametrize("case", ["homogeneous", "heterogeneous"])
def test_forward_twin_matches_jax_kernel(case):
    fleet, cost, x0, U0 = _setup(case)
    X0 = _nominal(fleet, cost, x0, U0)
    K, d = I._backward_pass(fleet.linearize, cost, jnp.asarray(X0),
                            jnp.asarray(U0), jnp.float64(1.0))
    alphas = I.line_search_alphas(10 if case == "homogeneous" else 4, np.float64)
    want = forward_pass_pallas(fleet, cost, jnp.asarray(X0), jnp.asarray(U0), K, d,
                               jnp.asarray(alphas), interpret=True)
    got = It._forward_pass(_port_fleet(fleet).step, _port_cost(cost),
                           torch.as_tensor(X0), torch.as_tensor(U0),
                           torch.as_tensor(np.asarray(K)), torch.as_tensor(np.asarray(d)),
                           torch.as_tensor(alphas))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", ["homogeneous", "single_agent"])
def test_rollout_twin_matches_jax_kernel(case):
    fleet, cost, x0, U0 = _setup(case)
    X_p, J_p = rollout_pallas(fleet, cost, jnp.asarray(x0), jnp.asarray(U0),
                              interpret=True)
    X_t, J_t = It._rollout_fn(_port_fleet(fleet).step, _port_cost(cost),
                              torch.as_tensor(x0), torch.as_tensor(U0))
    _close(X_t, X_p)
    np.testing.assert_allclose(float(J_t), float(J_p), rtol=RTOL)


def _scenario(name):
    """The tests/test_ilqr.py scenarios: (model, n, dt, N, x0, xf, Q, R, Qf,
    radius, U0, agent_mask)."""
    if name in ("single_unicycle", "warm_start"):
        U0 = None
        if name == "warm_start":
            U0 = np.random.default_rng(0).uniform(size=(50, 1, 2)) * 0.01
        return ("UNICYCLE_4D", 1, 0.05, 50, np.array([[-10.0, 10, 10, 0]]),
                np.zeros((1, 4)), np.diag([1.0, 1, 0, 0]), np.eye(2),
                1000 * np.eye(4), 0.0, U0, None)
    if name == "multi_agent":
        return ("DOUBLE_INT_4D", 3, 0.1, 30,
                np.array([[-2.0, 0.0, 0, 0], [2.0, 0.1, 0, 0], [0.0, -2.0, 0, 0]]),
                np.array([[2.0, 0.0, 0, 0], [-2.0, 0.1, 0, 0], [0.0, 2.0, 0, 0]]),
                np.eye(4), np.eye(2), 100 * np.eye(4), 1.0, None, None)
    if name == "multi_agent_asym":
        # Three agents whose paths cross off-centre: they pass within the
        # radius (closest 0.92) without the swap's symmetry.
        return ("DOUBLE_INT_4D", 3, 0.1, 30,
                np.array([[-2.0, 0.3, 0, 0], [2.0, -0.2, 0, 0], [0.4, -2.0, 0, 0]]),
                np.array([[2.0, -0.1, 0, 0], [-2.0, 0.25, 0, 0], [-0.3, 2.0, 0, 0]]),
                np.eye(4), np.eye(2), 100 * np.eye(4), 1.0, None, None)
    if name == "quad6d_single":
        return ("QUAD_6D", 1, 0.1, 40, np.array([[2.0, 2, 0.5, 0, 0, 0]]),
                np.zeros((1, 6)), np.eye(6), np.diag([0.0, 1, 1]), 100 * np.eye(6),
                0.0, None, None)
    # padded: two agents and a masked third slot
    return ("DOUBLE_INT_4D", 3, 0.1, 20,
            np.array([[-1.0, 0, 0, 0], [1.0, 0.1, 0, 0], [5.0, 5, 0, 0]]),
            np.array([[1.0, 0, 0, 0], [-1.0, 0.1, 0, 0], [0, 0, 0, 0]]),
            np.eye(4), np.eye(2), 50 * np.eye(4), 1.0, None, np.array([1.0, 1, 0]))


# Trajectory tolerance per scenario, relative to max|.|.  The symmetric
# three-agent swap is the one badly conditioned scenario: a 1e-15 relative
# perturbation of x0 moves the JAX package's own solution by 2.7e-8 there
# (1e-15 in the others), so its X and U are held to 1e-7; the asymmetric
# crossing (1e-12 there) holds three coupled agents to 1e-9.
SCENARIOS = {"single_unicycle": 1e-9, "multi_agent": 1e-7, "multi_agent_asym": 1e-9,
             "quad6d_single": 1e-9, "warm_start": 1e-9, "padded": 1e-9}


def _solve_both(name):
    model, n, dt, N, x0, xf, Q, R, Qf, radius, U0, mask = _scenario(name)
    kw = {} if mask is None else {"agent_mask": mask}
    cost = dtl.make_game_cost(xf, np.tile(Q, (n, 1, 1)), np.tile(R, (n, 1, 1)),
                              np.tile(Qf, (n, 1, 1)), radius=radius, **kw)
    fleet = dtl.homogeneous_fleet(getattr(dtl, model), n, dt)
    if U0 is None:
        rj = dtl.ilqr_solve(fleet, cost, jnp.asarray(x0), N=N)
        rt = dtt.ilqr_solve(_port_fleet(fleet), _port_cost(cost), torch.as_tensor(x0), N=N)
    else:
        rj = dtl.ilqr_solve(fleet, cost, jnp.asarray(x0), U0=jnp.asarray(U0))
        rt = dtt.ilqr_solve(_port_fleet(fleet), _port_cost(cost), torch.as_tensor(x0),
                            U0=torch.as_tensor(U0))
    return rj, rt


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ilqr_solve_matches_jax(name):
    rj, rt = _solve_both(name)
    assert int(rt.iters) == int(rj.iters) > 1
    assert bool(rt.converged) == bool(rj.converged)
    assert bool(rt.failed_line_search) == bool(rj.failed_line_search)
    np.testing.assert_allclose(float(rt.J), float(rj.J), rtol=1e-9)
    _close(rt.X, rj.X, SCENARIOS[name])
    _close(rt.U, rj.U, SCENARIOS[name])
    if name == "padded":  # masked slot controls never move
        assert float(rt.U[:, 2].abs().max()) == 0.0
    if name == "multi_agent_asym":  # the agents pass within the radius 1.0
        pos = rt.X[..., :2]
        dist = (pos[:, :, None] - pos[:, None]).norm(dim=-1) + 1e9 * torch.eye(3)
        assert float(dist.min()) < 1.0


def test_ilqr_solve_matches_oracle():
    model, n, dt, N, x0, xf, Q, R, Qf, radius, _, _ = _scenario("multi_agent")
    cost = dtt.make_game_cost(xf, np.tile(Q, (n, 1, 1)), np.tile(R, (n, 1, 1)),
                              np.tile(Qf, (n, 1, 1)), radius=radius, device="cpu")
    res = dtt.ilqr_solve(dtt.homogeneous_fleet(dtt.DOUBLE_INT_4D, n, dt), cost,
                         torch.as_tensor(x0), N=N)
    cost_o = OracleGameCost(xf.flatten(), [Q] * n, [R] * n, [Qf] * n, radius, 4, 2, n)
    X_o, _, J_o, iters_o, conv_o = oracle_ilqr(
        OracleMultiModel("DoubleInt4D", n, dt), cost_o, x0.flatten(), N=N)
    assert int(res.iters) == iters_o
    assert bool(res.converged) == conv_o
    np.testing.assert_allclose(float(res.J), J_o, rtol=1e-7)
    np.testing.assert_allclose(res.X.numpy().reshape(N + 1, n * 4), X_o, atol=1e-5)


def test_make_solver_equals_ilqr_solve():
    fleet, cost, x0, U0 = _setup("homogeneous")
    fleet_t, cost_t = _port_fleet(fleet), _port_cost(cost)
    cfg = dtt.SolverConfig(n_lqr_iter=6)
    solve = dtt.make_solver(fleet_t, U0.shape[0], cfg)
    a = solve(cost_t, torch.as_tensor(x0), torch.as_tensor(U0))
    b = dtt.ilqr_solve(fleet_t, cost_t, torch.as_tensor(x0), U0=U0, config=cfg)
    assert int(a.iters) == int(b.iters) > 0
    assert torch.equal(a.X, b.X) and torch.equal(a.J, b.J)
    with pytest.raises(ValueError, match="horizon"):
        solve(cost_t, torch.as_tensor(x0), torch.as_tensor(U0[:-1]))


def test_ilqr_solve_rejects_bad_shapes():
    fleet, cost, x0, U0 = _setup("homogeneous")
    fleet_t, cost_t = _port_fleet(fleet), _port_cost(cost)
    x0_t = torch.as_tensor(x0)
    with pytest.raises(ValueError, match="x0"):
        dtt.ilqr_solve(fleet_t, cost_t, x0_t[:3], N=5)
    with pytest.raises(ValueError, match="U0 or N"):
        dtt.ilqr_solve(fleet_t, cost_t, x0_t)
    with pytest.raises(ValueError, match="U0"):
        dtt.ilqr_solve(fleet_t, cost_t, x0_t, U0=np.zeros((5, 2, 4)))
    cost3 = _port_cost(dtl.make_game_cost(np.zeros((3, 4)), np.tile(np.eye(4), (3, 1, 1)),
                                          np.tile(np.eye(2), (3, 1, 1)),
                                          np.tile(np.eye(4), (3, 1, 1))))
    with pytest.raises(ValueError, match="agents"):
        dtt.ilqr_solve(fleet_t, cost3, x0_t, N=5)


def test_centralized_cost_crosses_over():
    """A single-problem cost (no leading subproblem axis) crosses from the
    JAX package through ``game_cost_from_numpy`` with its shapes and
    dtypes, and evaluates the same game cost."""
    fleet, cost, x0, U0 = _setup("heterogeneous")
    cost_t = _port_cost(cost)
    for (k, a), b in zip(cost._asdict().items(), cost_t):
        assert tuple(b.shape) == tuple(np.shape(a)), k
        assert b.dtype == (torch.int32 if k in ("n_pos", "n_pos_eval") else torch.float64)
    assert cost_t.radius.ndim == 0
    X0 = _nominal(fleet, cost, x0, U0)
    want = jax.vmap(lambda x, u: dtl.stage_cost(cost, x, u))(X0[:-1], U0)
    _close(dtt.stage_cost(cost_t, torch.as_tensor(X0[:-1]), torch.as_tensor(U0)), want)
    _close(dtt.terminal_cost(cost_t, torch.as_tensor(X0[-1])),
           dtl.terminal_cost(cost, X0[-1]))


def test_solve_rhc_centralized_matches_jax():
    n, N, dt = 3, 10, 0.1
    x0, xf = dtl.random_setup(n, 4, rng=np.random.default_rng(7), energy=4.0, n_d=2)
    cost = dtl.make_game_cost(xf, np.tile(np.eye(4), (n, 1, 1)),
                              np.tile(np.eye(2), (n, 1, 1)),
                              np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=0.5)
    kw = dict(centralized=True, step_size=1, J_converge=1e-3, t_diverge=2 * dt)
    rj = dtl.solve_rhc(dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt), cost, x0, N,
                       config=dtl.SolverConfig(n_lqr_iter=8),
                       rng=np.random.default_rng(0), **kw)
    rt = dtt.solve_rhc(dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, dt), _port_cost(cost),
                       x0, N, config=dtt.SolverConfig(n_lqr_iter=8),
                       rng=np.random.default_rng(0), device="cpu", **kw)
    assert len(rt.steps) == len(rj.steps) == 3
    assert rt.converged == rj.converged
    for st, sj in zip(rt.steps, rj.steps):
        assert st.iters == list(sj.iters) and st.iters[0] > 1
        assert st.graph is None and st.K is None
        np.testing.assert_allclose(st.J, sj.J, rtol=1e-9)
    np.testing.assert_allclose(rt.X, rj.X, atol=1e-9)
    np.testing.assert_allclose(rt.U, rj.U, atol=1e-8)
    np.testing.assert_allclose(rt.J, rj.J, rtol=1e-9)
    # A generous deadline changes nothing (the deadline solve is the same loop).
    rk = dtt.solve_rhc(dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, dt), _port_cost(cost),
                       x0, N, config=dtt.SolverConfig(n_lqr_iter=8), t_kill=1e9,
                       rng=np.random.default_rng(0), device="cpu", **kw)
    assert [s.iters for s in rk.steps] == [s.iters for s in rt.steps]
    np.testing.assert_array_equal(rk.X, rt.X)
