"""One decomposed solve with its subproblem batch split over a mesh
(``dpilqr_tpu_torch.solve_distributed_sharded``) on the CPU, float64.

16 unicycles (``random_setup`` at energy 40: neighbourhoods of up to 4
agents, so K = 4 drops no partner) at K = 4: the batch of 16 subproblems splits over 1, 3 (6, 6
and 4: ragged) and 8 CPU devices, and the result must equal the port's
``solve_distributed`` bit for bit (X, U, J, iterations, flags, membership,
sizes).  The retirement schedule's unit is lowered to 2 for these runs, so
that compaction fires in every chunk as it does at the main path's widths
on the card (16 lanes never compact at the unit of 16); the width of every
batched iteration is recorded to show it.  Then the solve is held against
``dpilqr_tpu.solve_distributed_sharded`` on a one-device JAX CPU mesh with
its XLA scans (tier-1 has no 8-device flag, so ``tests/test_sharding.py``
skips): equal iterations and flags, X within 1e-8 and J within 1e-9
relative, the tolerances of that file.  At energy 10-20 the 16 agents
crowd into neighbourhoods of 7-14, K = 4 truncates them, and the two
packages part by 3e-6 - 2e-3 in J; the JAX package parts from itself
further under a 1e-14 change of x0 (``tests/probe_c10.py``), so that is the
scenario's conditioning.  What is not rounding there, the graph and the
truncated gather, is held equal to the JAX package's at those energies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpilqr_tpu as dtl
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt

torch.set_num_threads(1)
n, N, K = 16, 12, 4
CFG = dict(n_lqr_iter=15)


def _scenario(make):
    rng = np.random.default_rng(2)
    x0, xf = dtt.random_setup(n, 4, rng=rng, energy=40.0, n_d=2)
    cost = make(xf, np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
                np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=0.5)
    return x0, cost


@pytest.fixture
def widths(monkeypatch):
    """The batch widths every batched iteration ran at, with the
    compaction unit at 2."""
    seen = []
    next_width, iteration = bt.next_width, bt.batched_iteration

    def record(fleet, cfg, sub_cost, mids_s, x0_s, c, backend="auto"):
        seen.append(x0_s.shape[0])
        return iteration(fleet, cfg, sub_cost, mids_s, x0_s, c, backend)

    monkeypatch.setattr(bt, "next_width", lambda w, unit=2: next_width(w, unit))
    monkeypatch.setattr(bt, "batched_iteration", record)
    return seen


@pytest.fixture(scope="module")
def problem():
    x0, cost = _scenario(lambda *a, **k: dtt.make_game_cost(*a, **k, device="cpu"))
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
    return fleet, cost, torch.as_tensor(x0)[None], torch.zeros((N, n, 2),
                                                              dtype=torch.float64)


@pytest.mark.parametrize("d", [1, 3, 8])
def test_sharded_is_solve_distributed_bit_for_bit(problem, widths, d):
    fleet, cost, X, U = problem
    cfg = dtt.SolverConfig(**CFG)
    ref = dtt.solve_distributed(fleet, cost, X, U, 0.5, K=K, config=cfg)
    assert len(set(widths)) > 1  # compaction fired
    widths.clear()
    res = dtt.solve_distributed_sharded(fleet, cost, X, U, 0.5,
                                        dtt.make_mesh(["cpu"] * d), K=K, config=cfg)
    assert len(set(widths)) > 1 if d < 8 else set(widths) == {2}
    assert max(widths) == -(-n // d)
    for name, a, b in zip(res._fields, res, ref):
        assert torch.equal(a, b), name
    assert int(res.iters.sum()) > n and res.converged.any()


def test_sharded_auto_width_and_ignored_agents(problem):
    fleet, cost, X, U = problem
    ignore = torch.zeros(n, dtype=torch.bool)
    ignore[2] = True
    cfg = dtt.SolverConfig(n_lqr_iter=3)
    ref = dtt.solve_distributed(fleet, cost, X, U, 0.5, ignore_mask=ignore, config=cfg)
    res = dtt.solve_distributed_sharded(fleet, cost, X[0], U, 0.5,
                                        dtt.make_mesh(["cpu", "cpu"]),
                                        ignore_mask=ignore, config=cfg)
    for name, a, b in zip(res._fields, res, ref):
        assert torch.equal(a, b), name
    assert not res.truncated and int(res.sizes.max()) > 1
    assert not res.X[:, 2].any() and int(res.iters[2]) == 0


def test_matches_jax_sharded_on_a_one_device_mesh(problem):
    fleet, cost, X, U = problem
    res = dtt.solve_distributed_sharded(fleet, cost, X, U, 0.5, dtt.make_mesh(["cpu"]),
                                        K=K, config=dtt.SolverConfig(**CFG))
    x0, jcost = _scenario(dtl.make_game_cost)
    rj = dtl.solve_distributed_sharded(
        dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1), jcost, jnp.asarray(x0)[None],
        jnp.zeros((N, n, 2)), 0.5, mesh=dtl.make_mesh(jax.devices("cpu")[:1]), K=K,
        config=dtl.SolverConfig(**CFG, sweep_backend="xla"))
    np.testing.assert_array_equal(res.membership.numpy(), np.asarray(rj.membership))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_allclose(float(res.J), float(rj.J), rtol=1e-9)
    np.testing.assert_allclose(res.X.numpy(), np.asarray(rj.X), rtol=0, atol=1e-8)


@pytest.mark.parametrize("energy", [10.0, 15.0, 20.0])
def test_truncated_graph_and_gather_equal_jax(energy):
    """Where K = 4 truncates neighbourhoods of 11-14 agents (energy 10-20,
    ROADMAP C10), the part of the two solves that is not rounding -- the
    interaction graph and the truncated gather -- is equal in both
    packages: membership, sizes, slots and ``truncated``."""
    from dpilqr_tpu.parallel.graph import interaction_graph as jax_graph
    from dpilqr_tpu.parallel.subproblems import gather_subproblems as jax_gather
    from dpilqr_tpu_torch.parallel.graph import interaction_graph
    from dpilqr_tpu_torch.parallel.subproblems import gather_subproblems

    x0, _ = dtt.random_setup(n, 4, rng=np.random.default_rng(2), energy=energy, n_d=2)
    x0j, _ = dtl.random_setup(n, 4, rng=np.random.default_rng(2), energy=energy, n_d=2)
    np.testing.assert_array_equal(x0, np.asarray(x0j))
    M = interaction_graph(torch.as_tensor(x0)[None], 0.5)
    Mj = jax_graph(jnp.asarray(x0)[None], 0.5)
    np.testing.assert_array_equal(M.numpy(), np.asarray(Mj))
    batch, jbatch = gather_subproblems(M, K), jax_gather(Mj, K)
    for name, a, b in zip(batch._fields, batch, jbatch):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(batch.sizes.max()) > K  # truncation is active
    assert bool(torch.any(batch.sizes > K)) == bool(jnp.any(jbatch.sizes > K))


def test_exported():
    assert dtt.solve_distributed_sharded is dtt.parallel.mesh.solve_distributed_sharded
    assert "solve_distributed_sharded" in dir(dtl)
