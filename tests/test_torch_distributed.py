"""CPU parity of the port's decomposed solve (dpilqr_tpu_torch.
solve_distributed) with the JAX package's ``_solve_distributed``, float64.

Both packages get the same seeded numpy scenario.  The JAX side runs its
vmapped XLA scans ("xla") and its Pallas kernels in interpret mode
("pallas-interpret"); the port runs the batched driver on the kernels'
torch twins.  Bounds are the JAX suite's own for its two paths
(tests/test_pallas_batched.py): equal membership, iterations and converged
flags; J rtol 1e-9; X atol 1e-8; U atol 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpilqr_tpu as dtl
from dpilqr_tpu.config import SolverConfig as ConfigJ
from dpilqr_tpu.ops.costs import make_game_cost
from dpilqr_tpu.parallel.distributed import _solve_distributed
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy

torch.set_num_threads(1)


def _problem(n, N, models=None, seed=3, energy=5.0):
    rng = np.random.default_rng(seed)
    dt, radius = 0.1, 0.5
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=energy, n_d=2)
    models = [dtl.UNICYCLE_4D] * n if models is None else models
    fleet = dtl.Fleet(tuple(models), dt)
    nx_p, nu_p = fleet.nx_p, fleet.nu_p
    x0p = np.zeros((n, nx_p))
    x0p[:, :4] = x0
    xfp = np.zeros((n, nx_p))
    xfp[:, :4] = xf
    cost = make_game_cost(
        xfp, np.tile(np.eye(nx_p), (n, 1, 1)), np.tile(np.eye(nu_p), (n, 1, 1)),
        np.tile(1e3 * np.eye(nx_p), (n, 1, 1)), radius=radius,
    )
    U0 = rng.uniform(size=(N, n, nu_p)) * 0.01 * fleet.control_mask[None]
    X0 = np.broadcast_to(x0p[None], (N + 1, n, nx_p)).copy()
    return fleet, cost, X0, U0, radius


def _solve_jax(fleet, cost, X0, U0, radius, K, backend, n_iter):
    cfg = ConfigJ(n_lqr_iter=n_iter, tol=1e-3, sweep_backend=backend)
    n = X0.shape[1]
    return _solve_distributed(
        fleet, cfg, K, None, cost, jnp.asarray(X0), jnp.asarray(U0),
        jnp.asarray(radius), jnp.zeros((n,), bool),
    )


def _solve_port(fleet, cost, X0, U0, radius, K, n_iter, **cfg):
    fleet_t = dtt.Fleet.from_names([s.name for s in fleet.specs], fleet.dt)
    cost_t = game_cost_from_numpy(
        {k: np.asarray(v) for k, v in cost._asdict().items()}, "cpu", torch.float64
    )
    config = dtt.SolverConfig(n_lqr_iter=n_iter, tol=1e-3, **cfg)
    return dtt.solve_distributed(
        fleet_t, cost_t, torch.as_tensor(X0), torch.as_tensor(U0), radius,
        K=K, config=config,
    )


def _assert_parity(rt, rj):
    np.testing.assert_array_equal(rt.membership.numpy(), np.asarray(rj.membership))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.sizes.numpy(), np.asarray(rj.sizes))
    assert bool(rt.truncated) == bool(rj.truncated)
    np.testing.assert_allclose(float(rt.J), float(rj.J), rtol=1e-9)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-8)
    np.testing.assert_allclose(rt.U.numpy(), np.asarray(rj.U), atol=1e-7)


HETERO = [dtl.UNICYCLE_4D, dtl.DOUBLE_INT_4D, dtl.UNICYCLE_4D, dtl.DOUBLE_INT_4D]
CASES = {
    # name: (n, N, models, seed, energy, K, n_iter)
    "homogeneous": (4, 6, None, 3, 5.0, 4, 5),
    "heterogeneous": (4, 6, HETERO, 3, 5.0, 4, 4),
    # A packed 5-agent start: neighborhoods of up to 5 cut to K=2.
    "truncated_K": (5, 6, None, 11, 3.0, 2, 4),
}


@pytest.mark.parametrize("backend", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_distributed_matches_jax(case, backend):
    n, N, models, seed, energy, K, n_iter = CASES[case]
    fleet, cost, X0, U0, radius = _problem(n, N, models, seed, energy)
    rj = _solve_jax(fleet, cost, X0, U0, radius, K, backend, n_iter)
    rt = _solve_port(fleet, cost, X0, U0, radius, K, n_iter)
    assert np.asarray(rj.iters).sum() > 0
    if case == "truncated_K":
        assert bool(rj.truncated)
    _assert_parity(rt, rj)


def test_mixed_rk4_substeps_matches_jax():
    models = [dtl.DOUBLE_INT_4D, dtl.BIKE_5D, dtl.DOUBLE_INT_4D, dtl.BIKE_5D]
    fleet, cost, X0, U0, radius = _problem(4, 6, models, seed=21)
    rj = _solve_jax(fleet, cost, X0, U0, radius, 4, "xla", 5)
    rt = _solve_port(fleet, cost, X0, U0, radius, 4, 5)
    _assert_parity(rt, rj)


def test_staged_compaction_matches_jax():
    # 70 subproblems: widths 70 -> 48 -> 32 -> 16 as subproblems finish.
    # A subproblem's iteration sequence cannot depend on its lane, so the
    # compacted solve must equal the lockstep XLA path exactly.
    assert bt.compaction_widths(70) == [70, 48, 32, 16]
    fleet, cost, X0, U0, radius = _problem(70, 5, seed=7)
    rj = _solve_jax(fleet, cost, X0, U0, radius, 4, "xla", 8)
    iters = np.asarray(rj.iters)
    # Precondition: finishing times spread across compaction boundaries.
    assert (iters < iters.max()).sum() > 70 - 48, iters
    rt = _solve_port(fleet, cost, X0, U0, radius, 4, 8)
    _assert_parity(rt, rj)


def test_two_stage_line_search_is_exact():
    fleet, cost, X0, U0, radius = _problem(12, 6, seed=13)
    r0 = _solve_port(fleet, cost, X0, U0, radius, 4, 8, ls_probe=0)
    r2 = _solve_port(fleet, cost, X0, U0, radius, 4, 8, ls_probe=2)
    assert int(r0.iters.sum()) > 0
    np.testing.assert_array_equal(r0.iters.numpy(), r2.iters.numpy())
    np.testing.assert_array_equal(r0.converged.numpy(), r2.converged.numpy())
    np.testing.assert_allclose(float(r2.J), float(r0.J), rtol=1e-12)
    np.testing.assert_allclose(r2.X.numpy(), r0.X.numpy(), atol=1e-12)


def test_auto_width_and_ignore_mask():
    fleet, cost, X0, U0, radius = _problem(6, 6, seed=5)
    fleet_t = dtt.Fleet.from_names([s.name for s in fleet.specs], fleet.dt)
    cost_t = game_cost_from_numpy(
        {k: np.asarray(v) for k, v in cost._asdict().items()}, "cpu", torch.float64
    )
    ignore = torch.tensor([False, True, False, False, False, False])
    r = dtt.solve_distributed(
        fleet_t, cost_t, torch.as_tensor(X0), torch.as_tensor(U0), radius,
        ignore_mask=ignore, config=dtt.SolverConfig(n_lqr_iter=3),
    )
    assert not bool(r.truncated)
    assert int(r.iters[1]) == 0
    assert float(r.X[:, 1].abs().max()) == 0.0 and float(r.U[:, 1].abs().max()) == 0.0
    assert np.isfinite(float(r.J))
    # The auto width is the largest neighborhood rounded up to a power of 2.
    from dpilqr_tpu_torch.parallel.distributed import _width_from_kmax

    assert [_width_from_kmax(k, 100) for k in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert _width_from_kmax(9, 6) == 6
    # A deadline forwards to the deadline solve; a generous one changes nothing.
    rk = dtt.solve_distributed(
        fleet_t, cost_t, torch.as_tensor(X0), torch.as_tensor(U0), radius,
        ignore_mask=ignore, config=dtt.SolverConfig(n_lqr_iter=3), t_kill=1e9,
    )
    assert torch.equal(rk.X, r.X) and torch.equal(rk.iters, r.iters)
    with pytest.raises(ValueError):
        dtt.solve_distributed(fleet_t, cost_t, torch.as_tensor(X0[:, :, :3]),
                              torch.as_tensor(U0), radius)
