"""Monte-Carlo trials as one batch (``dpilqr_tpu_torch.solve_trials_sharded``)
on the CPU, float64.

T trials of 6 unicycles at K = 4 flatten into one batch of 6 T
subproblems.  Each trial must be its own ``solve_distributed`` (the same
iterations and converged flags, X within 1e-10), the batch must match
``dpilqr_tpu.solve_trials_sharded`` on a one-device CPU mesh with its XLA
scans (the case of ``tests/test_sharding.py``), and a mesh of two CPU
devices, each solving a contiguous half, must give the one-device result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpilqr_tpu as dtl
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.parallel.mesh import _chunks, stack_costs

torch.set_num_threads(1)
n, N, T, K = 6, 12, 4, 4


def _trial(t):
    rng = np.random.default_rng(t)
    x0, xf = dtt.random_setup(n, 4, rng=rng, energy=10.0, n_d=2)
    return x0, xf


def _costs(make):
    return [make(_trial(t)[1], np.tile(np.eye(4), (n, 1, 1)),
                 np.tile(np.eye(2), (n, 1, 1)), np.tile(1e3 * np.eye(4), (n, 1, 1)),
                 radius=0.5)
            for t in range(T)]


@pytest.fixture(scope="module")
def port():
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
    costs = _costs(lambda *a, **k: dtt.make_game_cost(*a, **k, device="cpu"))
    X_T = np.stack([np.broadcast_to(_trial(t)[0][None], (2, n, 4)) for t in range(T)])
    U_T = np.zeros((T, N, n, 2))
    cfg = dtt.SolverConfig(n_lqr_iter=5)
    res = dtt.solve_trials_sharded(fleet, stack_costs(costs), X_T, U_T, 0.5,
                                   mesh=dtt.make_mesh(["cpu"]), K=K, config=cfg)
    return fleet, costs, X_T, U_T, cfg, res


def test_result_has_a_trial_axis(port):
    *_, res = port
    assert res.X.shape == (T, N + 1, n, 4) and res.U.shape == (T, N, n, 2)
    assert res.J.shape == (T,) and res.iters.shape == (T, n)
    assert res.membership.shape == (T, n, n) and res.truncated.shape == (T,)
    assert int(res.iters.sum()) > T * n  # a solve, not one iteration a lane


@pytest.mark.parametrize("t", range(T))
def test_each_trial_is_its_own_solve_distributed(port, t):
    fleet, costs, X_T, U_T, cfg, res = port
    ref = dtt.solve_distributed(fleet, costs[t], torch.as_tensor(X_T[t]),
                                torch.as_tensor(U_T[t]), 0.5, K=K, config=cfg)
    assert torch.equal(res.membership[t], ref.membership)
    assert torch.equal(res.iters[t], ref.iters)
    assert torch.equal(res.converged[t], ref.converged)
    np.testing.assert_allclose(res.X[t].numpy(), ref.X.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(res.J[t]), float(ref.J), rtol=1e-12)


def test_matches_jax_trials_on_a_one_device_mesh(port):
    fleet, _, X_T, U_T, cfg, res = port
    costs = _costs(dtl.make_game_cost)
    cost_T = jax.tree.map(lambda *ls: jnp.stack(ls), *costs)
    rj = dtl.solve_trials_sharded(
        dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1), cost_T, jnp.asarray(X_T),
        jnp.asarray(U_T), 0.5, mesh=dtl.make_mesh(jax.devices("cpu")[:1]), K=K,
        config=dtl.SolverConfig(n_lqr_iter=5, sweep_backend="xla"))
    np.testing.assert_array_equal(res.membership.numpy(), np.asarray(rj.membership))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_allclose(res.J.numpy(), np.asarray(rj.J), rtol=1e-9)
    np.testing.assert_allclose(res.X.numpy(), np.asarray(rj.X), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.U.numpy(), np.asarray(rj.U), rtol=0, atol=1e-7)


def test_two_device_mesh_gives_the_one_device_result(port):
    fleet, costs, X_T, U_T, cfg, res = port
    assert _chunks(T * n, 2) == [slice(0, 12), slice(12, 24)]
    assert _chunks(10, 3) == [slice(0, 4), slice(4, 8), slice(8, 10)]
    r2 = dtt.solve_trials_sharded(fleet, stack_costs(costs), X_T, U_T, 0.5,
                                  mesh=dtt.make_mesh(["cpu", "cpu"]), K=K, config=cfg)
    for a, b in zip(r2, res):
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
        else:
            assert torch.equal(a, b)


def test_ignored_agents_stay_zero(port):
    fleet, costs, X_T, U_T, cfg, _ = port
    ignore = np.zeros(n, bool)
    ignore[1] = True
    res = dtt.solve_trials_sharded(fleet, stack_costs(costs[:2]), X_T[:2], U_T[:2],
                                   0.5, mesh=dtt.make_mesh(["cpu"]), K=K,
                                   ignore_mask=ignore, config=cfg)
    assert not res.X[:, :, 1].any() and not res.U[:, :, 1].any()
    assert (res.iters[:, 1] == 0).all() and res.X[:, :, 0].any()


def test_make_mesh_lists_devices():
    assert dtt.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if torch.cuda.is_available():
        assert len(dtt.make_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            dtt.make_mesh()
