"""Parity of the port's wide decomposed subproblems (K * nx_p > 32) with
the JAX package, float64.

The backward kernel for wide subproblems (``csrc/backward_batched_wide.cu``)
has the same twin as the narrow one, ``backward_pass_batched_torch``; it is
held here against ``dpilqr_tpu.ops.pallas_batched_wide.
backward_pass_batched_wide`` in interpret mode, at the mixed DoubleInt4D +
Car3D + Bike5D fleet at K=8 (nxf 40) and at Quad6D at K=8 (nxf 48), S=2,
N=3, rtol 1e-10 relative to max|.|.  The forward twin is held against the
JAX forward kernel at nxf 48, and the whole decomposed solve of a Quad6D
fleet at K=8 against the JAX package's, at the scale of
``tests/test_pallas_wide.py::test_distributed_solve_through_wide_kernel``.

The ``cuda`` cases hold the kernels against the twins on a card and skip
without one.
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy
from dpilqr_tpu_torch.ops.cuda_build import SMEM_LIMIT, cluster_max, riccati_plan
from dpilqr_tpu_torch.ops.ilqr import line_search_alphas

torch.set_num_threads(1)

RTOL = 1e-10
S, K, N = 2, 8, 3
HETERO = ["DoubleInt4D", "Car3D", "Bike5D"]


def _batch(names, seed=0, S=S, K=K, spread=0.3):
    """Seeded batch of S subproblems with K slots over the models
    ``names``: cost fields, branch indices, X, U, mu (numpy); states and
    controls normal with deviation ``spread``."""
    rng = np.random.default_rng(seed)
    fleet = dtt.Fleet.from_names(names, 0.1)
    nx_p, nu_p = fleet.nx_p, fleet.nu_p
    mids = rng.integers(0, len(names), (S, K)).astype(np.int32)
    mask = np.ones((S, K))
    mask[1, K - 1] = 0.0  # one padded slot
    smask = np.stack([[fleet.state_mask[m] for m in row] for row in mids])
    umask = np.stack([[fleet.control_mask[m] for m in row] for row in mids])
    # Slots clustered within the radius so proximity pairs are active.
    X = spread * rng.standard_normal((S, N + 1, K, nx_p)) * smask[:, None]
    U = spread * rng.standard_normal((S, N, K, nu_p)) * umask[:, None]
    U = U * mask[:, None, :, None]
    n_pos = 3 if nx_p >= 6 else 2
    fields = dict(
        xf=rng.uniform(-1, 1, (S, K, nx_p)) * smask,
        Q=np.tile(np.eye(nx_p), (S, K, 1, 1)),
        R=np.tile(np.eye(nu_p), (S, K, 1, 1)),
        Qf=np.tile(100.0 * np.eye(nx_p), (S, K, 1, 1)),
        radius=np.full((S,), 0.5),
        n_pos=np.full((S, K), n_pos, np.int32),
        agent_mask=mask,
        prox_weight=np.full((S,), 200.0),
        ref_weight=np.full((S,), 1.0),
        n_pos_eval=np.full((S, K), n_pos, np.int32),
    )
    return fleet, fields, mids, X, U, np.linspace(0.5, 1.5, S)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _jax_cost(fields):
    import jax.numpy as jnp

    from dpilqr_tpu.ops.costs import GameCost

    return GameCost(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("names", [HETERO, ["Quad6D"]], ids=["hetero-nxf40", "quad6d-nxf48"])
def test_backward_twin_matches_jax_wide_kernel(names):
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.ops.pallas_batched_wide import backward_pass_batched_wide

    fleet_t, fields, mids, X, U, mu = _batch(names)
    assert K * fleet_t.nx_p in (40, 48)
    Kg_j, d_j = backward_pass_batched_wide(
        dtl.Fleet(tuple(names), 0.1), _jax_cost(fields), jnp.asarray(mids),
        jnp.asarray(X), jnp.asarray(U), jnp.asarray(mu), interpret=True,
    )
    cost_t = game_cost_from_numpy(fields, "cpu", torch.float64)
    Xt = torch.as_tensor(X)
    # Precondition: the batch couples slots through active pairs.
    pc = dtt.proximity_cost(bt._time_cost(cost_t), Xt[:, :-1])
    assert float(pc.sum()) > 0.0
    Kg, d = bt.backward_pass_batched(
        fleet_t, cost_t, torch.as_tensor(mids), Xt, torch.as_tensor(U),
        torch.as_tensor(mu),
    )
    _close(Kg, Kg_j)
    _close(d, d_j)


def test_forward_twin_matches_jax_kernel_at_nxf48():
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.ops import pallas_batched as pj

    fleet_t, fields, mids, X, U, _ = _batch(["Quad6D"], seed=1)
    rng = np.random.default_rng(2)
    nxf, nuf = K * fleet_t.nx_p, K * fleet_t.nu_p
    assert nxf == 48
    Kg = 0.1 * rng.standard_normal((N, nuf, nxf, S))
    d = 0.1 * rng.standard_normal((N, nuf, S))
    alphas = np.asarray(dtl.ops.line_search_alphas(3, np.float64))
    Xn = X + 0.05 * rng.standard_normal(X.shape)  # nonzero dx
    want = pj.forward_pass_batched(
        dtl.Fleet(("Quad6D",), 0.1), _jax_cost(fields), None, jnp.asarray(Xn),
        jnp.asarray(U), jnp.asarray(Kg), jnp.asarray(d), jnp.asarray(alphas),
        interpret=True,
    )
    got = bt.forward_pass_batched(
        fleet_t, game_cost_from_numpy(fields, "cpu", torch.float64),
        torch.as_tensor(mids), torch.as_tensor(Xn), torch.as_tensor(U),
        torch.as_tensor(Kg), torch.as_tensor(d), torch.as_tensor(alphas),
    )
    for g, w in zip(got, want):
        _close(g, w)


def _quad6d_fleet_problem():
    """8 Quad6D agents on a jittered 2x2x2 cube of side 0.55, all within
    twice the radius of each other: one neighbourhood of 8 (nxf 48), N=4 --
    the scale of tests/test_pallas_wide.py::
    test_distributed_solve_through_wide_kernel, with coupling."""
    import dpilqr_tpu as dtl

    n, Nh = 8, 4
    rng = np.random.default_rng(3)
    corners = np.stack(np.meshgrid(*[[0.0, 0.55]] * 3, indexing="ij"), -1).reshape(-1, 3)
    x0 = np.zeros((n, 6))
    x0[:, :3] = corners + rng.uniform(-0.03, 0.03, (n, 3))
    xf = np.zeros((n, 6))
    xf[:, :3] = corners[::-1] + rng.uniform(-0.03, 0.03, (n, 3))
    cost = dtl.make_game_cost(
        xf, np.tile(np.eye(6), (n, 1, 1)), np.tile(np.eye(3), (n, 1, 1)),
        np.tile(1e3 * np.eye(6), (n, 1, 1)), radius=0.5,
        n_pos=np.full((n,), 3, np.int32),
    )
    return dtl.homogeneous_fleet(dtl.QUAD_6D, n, 0.1), cost, x0, Nh


def test_solve_distributed_wide_matches_jax():
    import jax.numpy as jnp

    from dpilqr_tpu.config import SolverConfig as ConfigJ
    from dpilqr_tpu.parallel.distributed import _solve_distributed

    fleet, cost, x0, Nh = _quad6d_fleet_problem()
    n = fleet.n_agents
    X0 = np.broadcast_to(x0[None], (Nh + 1, n, 6)).copy()
    # Hover thrust plus a small seeded perturbation.
    U0 = np.zeros((Nh, n, 3))
    U0[..., 0] = 9.80665
    U0 = U0 + 0.01 * np.random.default_rng(4).uniform(size=U0.shape)
    rj = _solve_distributed(
        fleet, ConfigJ(n_lqr_iter=5, tol=1e-3, sweep_backend="xla"), K, None,
        cost, jnp.asarray(X0), jnp.asarray(U0), jnp.asarray(0.5),
        jnp.zeros((n,), bool),
    )
    cost_t = game_cost_from_numpy(
        {k: np.asarray(v) for k, v in cost._asdict().items()}, "cpu", torch.float64
    )
    rt = dtt.solve_distributed(
        dtt.homogeneous_fleet(dtt.QUAD_6D, n, 0.1), cost_t, torch.as_tensor(X0),
        torch.as_tensor(U0), 0.5, K=K,
        config=dtt.SolverConfig(n_lqr_iter=5, tol=1e-3),
    )
    assert int(rt.sizes.min()) == n  # every neighbourhood fills the 8 slots
    assert int(rt.iters.sum()) > n  # more than one iteration somewhere
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_allclose(float(rt.J), float(rj.J), rtol=1e-9)
    _close(rt.X, rj.X, 1e-9)
    _close(rt.U, rj.U, 1e-9)


# ---------------------------------------------------------------------------
# On a card: the wide kernel and the widened forward kernel against the twins.
# ---------------------------------------------------------------------------


# K3's plan with its cluster tier (``riccati_plan`` with ``max_cluster``,
# ``wide_plan`` in csrc/plan.h): the narrow widths, the routed
# Quad6D/Quad12D/mixed widths and past them.
PLAN_SHAPES = [(1, 4, 2), (4, 4, 2), (8, 4, 2), (8, 5, 2), (8, 6, 3), (16, 6, 3),
               (20, 6, 3), (24, 6, 3), (32, 6, 3), (4, 12, 4), (8, 12, 4), (16, 12, 4),
               (32, 12, 4), (24, 4, 2), (32, 3, 2), (32, 4, 2), (64, 4, 2), (32, 5, 2)]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "K{}nx{}nu{}".format(*s))
def test_cluster_tier_replaces_only_the_workspace_tier(shape, itemsize):
    K, nx, nu = shape
    base = riccati_plan(K, nx, nu, itemsize)
    plan = riccati_plan(K, nx, nu, itemsize, cluster_max())
    assert base.cluster == 1 and cluster_max() == 8
    if (K * nx <= bt.MAX_NXF or base.tier in (0, 1)
            or K * (nx + nu) + 1 <= 160):
        # Every narrow shape, every shape one CTA holds (tier 0), every
        # tier-1 shape and every tier-2 shape whose tableau the register
        # path eliminates (up to 160 columns) keeps its plan.
        assert plan == base
        return
    assert base.tier == 2
    if plan.tier == 3:
        # The smallest cluster of at most eight CTAs that holds the whole
        # working set, nothing of it in the workspace: one CTA fewer leaves
        # the problem in the workspace.
        C = plan.cluster
        assert 2 <= C <= min(cluster_max(), K)
        assert 0 < plan.smem <= SMEM_LIMIT and plan.work == 0
        assert riccati_plan(K, nx, nu, itemsize, C - 1) == base
    else:
        assert plan == base
    if shape == (32, 6, 3):
        # The quad6d_64 loop's widest steps: a cluster of eight in float32;
        # float64 (1.9 MB) stays in the workspace.
        assert (plan.tier, plan.cluster) == ((3, 8) if itemsize == 4 else (2, 1))
    if shape == (32, 5, 2) and itemsize == 4:
        # The hetero99 loop's widest steps (DoubleInt4D, Car3D and Bike5D
        # slots padded to nx 5, nu 2): a cluster of four.
        assert (plan.tier, plan.cluster) == (3, 4)



def test_tier_counts_count_each_launch_of_a_backward_kernel():
    from dpilqr_tpu_torch.ops import cuda_build

    cuda_build.reset_launch_counts()
    b = cuda_build.Bound("backward_batched_wide", None, None, (), (), (), 3)
    for _ in range(3):  # a graph's replays count as launches
        cuda_build.count(b)
    cuda_build.count(b._replace(tier=1))
    cuda_build.count(b._replace(kernel="forward_batched", tier=None))
    assert cuda_build.tier_counts == {("backward_batched_wide", 3): 3,
                                      ("backward_batched_wide", 1): 1}
    assert cuda_build.launch_counts["backward_batched_wide"] == 4
    cuda_build.reset_launch_counts()
    assert cuda_build.tier_counts == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# Quad6D at K=16, S=64 is the quad6d_64 loop's shape (nxf 96, nuf 48); in
# float64 its gain blocks exceed shared memory and the kernel keeps them in
# device memory.  At K=32 (nxf 192, the loop's widest steps) float32 takes
# a cluster of eight CTAs (the cluster tier) and float64 keeps the
# device-memory workspace (tier 2).  Quad6D at K=24 (nxf 144) takes a
# cluster of 5 CTAs owning 5, 5, 5, 5 and 4 slots in float32; Unicycle4D
# at K=32 (nxf 128) one of 4 in float32 and of 7 in float64; the mixed
# fleet at K=32 (nxf 160) one of 4 in float32 (the hetero99 loop's widest
# steps) and the workspace in float64.  24 or 32
# slots at a spread of 0.3 pack every slot inside the radius: gains of 2e3
# whose float32 rounding alone is percents (the kernel gives tier 2's bits
# there), so those batches are spread out to 1.0.
@pytest.mark.cuda
@pytest.mark.parametrize("names,shape", [(HETERO, (S, K)), (["Quad6D"], (S, K)),
                                         (["Quad12D"], (S, K)), (["Quad6D"], (64, 16)),
                                         (["Quad6D"], (64, 32)), (["Quad6D"], (16, 24)),
                                         (["Unicycle4D"], (16, 32)), (HETERO, (16, 32))],
                         ids=["nxf40", "nxf48", "nxf96", "nxf96-nuf48", "nxf192", "nxf144",
                              "nxf128", "nxf160"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_wide_kernels_match_twins(cuda_device, names, shape, dtype):
    tol = {torch.float64: (1e-9, 1e-9), torch.float32: (2e-3, 1e-4)}[dtype]
    fleet_t, fields, mids, X, U, mu = _batch(names, seed=5, S=shape[0], K=shape[1],
                                             spread=1.0 if shape[1] >= 24 else 0.3)
    if names == ["Quad12D"]:
        U = 1e-4 * U  # Quad12D's torque gains are ~6e4
    cost_t = game_cost_from_numpy(fields, cuda_device, dtype)
    mids_t = torch.as_tensor(mids, device=cuda_device)
    Xt, Ut, mut = (torch.as_tensor(a, dtype=dtype, device=cuda_device) for a in (X, U, mu))
    Kg_t, d_t = bt.backward_pass_batched(fleet_t, cost_t, mids_t, Xt, Ut, mut, "torch")
    Kg_c, d_c = bt.backward_pass_batched(fleet_t, cost_t, mids_t, Xt, Ut, mut, "cuda")
    for a, b in ((Kg_c, Kg_t), (d_c, d_t)):
        assert float((a - b).abs().max()) <= tol[0] * float(b.abs().max())
    # The forward pass under these gains scaled to max|Kg| = 0.1: at N=3 the
    # Riccati gains of the random batches reach ~300 and drive the
    # quadrotors' tan(angle) terms chaotic, so that float32 rounding alone
    # moves the rollout by 1e-2 (float32 vs float64 twin, Quad6D); scaled,
    # the twins agree to 3e-7.
    s = 0.1 / float(Kg_t.abs().max())
    alphas = line_search_alphas(10, dtype, cuda_device)
    args = (fleet_t, cost_t, mids_t, Xt, Ut, s * Kg_t, s * d_t, alphas)
    for a, b in zip(bt.forward_pass_batched(*args, backend="cuda"),
                    bt.forward_pass_batched(*args, backend="torch")):
        assert float((a - b).abs().max()) <= tol[1] * float(b.abs().max())
