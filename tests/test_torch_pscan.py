"""The port's associative-scan Riccati sweep (dpilqr_tpu_torch.ops.pscan)
against the JAX package's (dpilqr_tpu.ops.pscan) and against the port's own
sequential sweep, float64 on the CPU.

Scenarios and tolerance follow ``tests/test_pscan.py``: 3 unicycles over
N = 120 at mu = 0, 1 and 37.5, gains to atol 1e-9.  The port's hand-written
log-depth scan groups its combines differently from
``jax.lax.associative_scan``, so the two agree to rounding, not bitwise.  A
``sweep_backend="pscan"`` solve must take the same iterations as the JAX
solve and agree on J to 1e-9 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpilqr_tpu as dtl
from dpilqr_tpu.ops import pscan as pscan_j
from dpilqr_tpu.ops.ilqr import _rollout_fn as rollout_j
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import ilqr as It
from dpilqr_tpu_torch.ops import pscan as pscan_t
from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy

torch.set_num_threads(1)


def _setup(n, N, seed=0):
    """The scenario of tests/test_pscan.py on both sides."""
    rng = np.random.default_rng(seed)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=5.0, n_d=2)
    fleet_j = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    cost_j = dtl.make_game_cost(
        jnp.asarray(xf), np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=0.5,
    )
    U = rng.uniform(size=(N, n, 2)) * 0.1
    fleet_t = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
    cost_t = game_cost_from_numpy(
        {k: np.asarray(v) for k, v in cost_j._asdict().items()}, "cpu", torch.float64)
    return fleet_j, cost_j, fleet_t, cost_t, np.asarray(x0), U


@pytest.mark.parametrize("n_elems", [1, 2, 3, 4, 5, 8, 9, 16, 21])
def test_assoc_scan_equals_the_sequential_fold(n_elems):
    # Affine maps x -> M x + v compose associatively and do not commute.
    rng = np.random.default_rng(n_elems)
    M = torch.as_tensor(rng.normal(size=(n_elems, 3, 3)) / 2)
    v = torch.as_tensor(rng.normal(size=(n_elems, 3)))

    def compose(first, then):
        return then[0] @ first[0], (then[0] @ first[1][..., None])[..., 0] + then[1]

    got = pscan_t._assoc_scan(compose, (M, v))
    acc = (M[0], v[0])
    for i in range(n_elems):
        if i:
            acc = compose(acc, (M[i], v[i]))
        torch.testing.assert_close(got[0][i], acc[0], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got[1][i], acc[1], rtol=1e-12, atol=1e-12)


def test_combine_matches_jax():
    rng = np.random.default_rng(5)
    m, nb = 6, 4

    def elem():
        A = rng.normal(size=(nb, m, m)) / 3
        b = rng.normal(size=(nb, m))
        C = rng.normal(size=(nb, m, m))
        C = C @ C.transpose(0, 2, 1) / m  # PSD, like B Luu^-1 B^T
        eta = rng.normal(size=(nb, m))
        J = rng.normal(size=(nb, m, m))
        J = J @ J.transpose(0, 2, 1) / m  # PSD, like a value Hessian
        return A, b, C, eta, J

    e1, e2 = elem(), elem()
    want = pscan_j._combine(tuple(map(jnp.asarray, e1)), tuple(map(jnp.asarray, e2)))
    got = pscan_t._combine(tuple(map(torch.as_tensor, e1)),
                           tuple(map(torch.as_tensor, e2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mu", [0.0, 1.0, 37.5])
def test_pscan_backward_matches_sequential_and_jax(mu):
    fleet_j, cost_j, fleet_t, cost_t, x0, U = _setup(3, 120)
    Xj, _ = rollout_j(fleet_j.step, cost_j, jnp.asarray(x0), jnp.asarray(U))
    Kj, dj = pscan_j.backward_pass_pscan(
        fleet_j.linearize, cost_j, Xj, jnp.asarray(U), jnp.asarray(mu))
    Xt, Ut = torch.as_tensor(np.asarray(Xj)), torch.as_tensor(U)
    mu_t = torch.tensor(mu, dtype=torch.float64)
    Ks, ds = It._backward_pass(fleet_t.linearize, cost_t, Xt, Ut, mu_t)
    Kp, dp = pscan_t.backward_pass_pscan(fleet_t.linearize, cost_t, Xt, Ut, mu_t)
    assert Kp.shape == Ks.shape == (120, 6, 12) and dp.shape == ds.shape
    # Against the port's own sequential sweep, and against the JAX scan.
    np.testing.assert_allclose(Kp.numpy(), Ks.numpy(), atol=1e-9)
    np.testing.assert_allclose(dp.numpy(), ds.numpy(), atol=1e-9)
    np.testing.assert_allclose(Kp.numpy(), np.asarray(Kj), atol=1e-9)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), atol=1e-9)


def test_pscan_backward_short_and_odd_horizons():
    for N in (1, 2, 7):
        _, _, fleet_t, cost_t, x0, U = _setup(2, N, seed=N)
        Ut = torch.as_tensor(U)
        Xt, _ = dtt.rollout(fleet_t, cost_t, torch.as_tensor(x0), Ut)
        mu = torch.tensor(1.0, dtype=torch.float64)
        Ks, ds = It._backward_pass(fleet_t.linearize, cost_t, Xt, Ut, mu)
        Kp, dp = pscan_t.backward_pass_pscan(fleet_t.linearize, cost_t, Xt, Ut, mu)
        np.testing.assert_allclose(Kp.numpy(), Ks.numpy(), atol=1e-9)
        np.testing.assert_allclose(dp.numpy(), ds.numpy(), atol=1e-9)


def test_pscan_solve_matches_jax():
    fleet_j, cost_j, fleet_t, cost_t, x0, U = _setup(4, 40, seed=2)
    rj = dtl.ilqr_solve(
        fleet_j, cost_j, jnp.asarray(x0), U0=jnp.asarray(U),
        config=dtl.SolverConfig(n_lqr_iter=10, sweep_backend="pscan"))
    cfg = dtt.SolverConfig(n_lqr_iter=10, sweep_backend="pscan")
    rt = dtt.ilqr_solve(fleet_t, cost_t, torch.as_tensor(x0), U0=torch.as_tensor(U),
                        config=cfg)
    assert int(rt.iters) == int(rj.iters) > 1
    assert bool(rt.converged) == bool(rj.converged)
    assert bool(rt.failed_line_search) == bool(rj.failed_line_search)
    np.testing.assert_allclose(float(rt.J), float(rj.J), rtol=1e-9)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-7)
    # The scan changes the backward sweep only: the port's default solve
    # takes the same iterations to the same plan.
    rs = dtt.ilqr_solve(fleet_t, cost_t, torch.as_tensor(x0), U0=torch.as_tensor(U),
                        config=dtt.SolverConfig(n_lqr_iter=10))
    assert int(rs.iters) == int(rt.iters)
    np.testing.assert_allclose(float(rt.J), float(rs.J), rtol=1e-10)
    # The decomposed solve has no scan and reads "pscan" as "auto".
    X0 = torch.as_tensor(x0)[None]
    a = dtt.solve_distributed(fleet_t, cost_t, X0, torch.as_tensor(U), 0.5, config=cfg)
    b = dtt.solve_distributed(fleet_t, cost_t, X0, torch.as_tensor(U), 0.5,
                              config=dtt.SolverConfig(n_lqr_iter=10))
    assert torch.equal(a.X, b.X) and torch.equal(a.iters, b.iters)
