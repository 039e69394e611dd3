"""Parity of the port's batched sweeps (dpilqr_tpu_torch.ops.batched) with
the JAX package's Pallas kernels (dpilqr_tpu.ops.pallas_batched), float64.

On the CPU the JAX kernels run in interpret mode and the port runs the
kernels' plain PyTorch twins; both get the same seeded numpy inputs: a
batch of S=5 subproblems with K=4 slots over N=6 steps, with a padded slot
and proximity pairs inside the radius.  Tolerance rtol 1e-10 (relative to
max|.|): the two packages contract the same block algebra in different
orders.

The ``cuda`` cases hold the CUDA kernels against the same twins on a card
and skip without one.  They need no JAX, so on a machine without it they
run alone with ``python -m pytest tests/test_torch_batched.py -m cuda
--noconftest``; the JAX side is imported by the ``jx`` fixture.
"""

import types

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy
from dpilqr_tpu_torch.ops.cuda_build import forward_plan, riccati_plan
from dpilqr_tpu_torch.ops.ilqr import line_search_alphas

torch.set_num_threads(1)

RTOL = 1e-10
S, K, N = 5, 4, 6


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.ops import pallas_batched as pj
    from dpilqr_tpu.ops.costs import GameCost

    def fleet(names):
        return dtl.Fleet(tuple(names), 0.1)

    def cost(fields):
        return GameCost(**{k: jnp.asarray(v) for k, v in fields.items()})

    return types.SimpleNamespace(dtl=dtl, pj=pj, jnp=jnp, fleet=fleet, cost=cost)


def _batch(names, seed=0, dtype=np.float64):
    """Seeded numpy batch over the models ``names``: cost fields (S
    leading), branch indices (S, K), X (S, N+1, K, nx_p), U (S, N, K, nu_p),
    mu (S,)."""
    rng = np.random.default_rng(seed)
    fleet = dtt.Fleet.from_names(names, 0.1)
    nx_p, nu_p = fleet.nx_p, fleet.nu_p
    mids = rng.integers(0, len(names), (S, K)).astype(np.int32)
    mask = np.ones((S, K))
    mask[1, 3] = 0.0  # one padded slot
    smask = np.stack([[fleet.state_mask[m] for m in row] for row in mids])
    umask = np.stack([[fleet.control_mask[m] for m in row] for row in mids])
    # Slots clustered within the radius so proximity pairs are active.
    X = 0.25 * rng.standard_normal((S, N + 1, K, nx_p)) * smask[:, None]
    U = 0.3 * rng.standard_normal((S, N, K, nu_p)) * umask[:, None]
    U = U * mask[:, None, :, None]
    fields = dict(
        xf=rng.uniform(-1, 1, (S, K, nx_p)) * smask,
        Q=np.tile(np.eye(nx_p), (S, K, 1, 1)),
        R=np.tile(np.eye(nu_p), (S, K, 1, 1)),
        Qf=np.tile(100.0 * np.eye(nx_p), (S, K, 1, 1)),
        radius=np.full((S,), 0.5),
        n_pos=np.full((S, K), 2, np.int32),
        agent_mask=mask,
        prox_weight=np.full((S,), 200.0),
        ref_weight=np.full((S,), 1.0),
        n_pos_eval=np.full((S, K), 2, np.int32),
    )
    mu = np.linspace(0.5, 1.5, S)
    return fleet, fields, mids, X.astype(dtype), U.astype(dtype), mu


def _port(fields, mids, dtype=torch.float64, device="cpu"):
    cost_t = game_cost_from_numpy(fields, device, dtype)
    return cost_t, torch.as_tensor(mids, device=device)


def _close(got, want):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.fixture(scope="module")
def homogeneous(jx):
    fleet, fields, mids, X, U, mu = _batch(["Unicycle4D"])
    cost_j = jx.cost(fields)
    jnp = jx.jnp
    Kg, d = jx.pj.backward_pass_batched(
        jx.fleet(["Unicycle4D"]), cost_j, jnp.asarray(mids), jnp.asarray(X),
        jnp.asarray(U), jnp.asarray(mu), interpret=True,
    )
    return fleet, fields, mids, X, U, mu, cost_j, np.asarray(Kg), np.asarray(d)


def test_backward_twin_matches_jax_kernel(homogeneous):
    fleet_t, fields, mids, X, U, mu, _, Kg_j, d_j = homogeneous
    # Precondition: the batch couples slots through active pairs.
    from dpilqr_tpu_torch.ops.costs import proximity_cost

    cost_t, mids_t = _port(fields, mids)
    Xt = torch.as_tensor(X)
    pc = proximity_cost(bt._time_cost(cost_t), Xt[:, :-1])
    assert float(pc.sum()) > 0.0
    Kg, d = bt.backward_pass_batched(
        fleet_t, cost_t, mids_t, Xt, torch.as_tensor(U), torch.as_tensor(mu)
    )
    _close(Kg, Kg_j)
    _close(d, d_j)
    # Padded slot: its gain rows see no real slot and no state.
    assert float(Kg[:, 6:8, :, 1].abs().max()) == 0.0


@pytest.mark.parametrize(
    "n_alpha,gains", [(2, True), (10, True), (2, False)],
    ids=["2alphas", "10alphas", "no_gains"],
)
def test_forward_twin_matches_jax_kernel(jx, homogeneous, n_alpha, gains):
    fleet_t, fields, mids, X, U, mu, cost_j, Kg_j, d_j = homogeneous
    jnp = jx.jnp
    alphas = np.asarray(jx.dtl.ops.line_search_alphas(n_alpha, np.float64))
    want = jx.pj.forward_pass_batched(
        jx.fleet(["Unicycle4D"]), cost_j, None, jnp.asarray(X), jnp.asarray(U),
        jnp.asarray(Kg_j) if gains else None,
        jnp.asarray(d_j) if gains else None, jnp.asarray(alphas),
        interpret=True,
    )
    cost_t, mids_t = _port(fields, mids)
    got = bt.forward_pass_batched(
        fleet_t, cost_t, mids_t, torch.as_tensor(X), torch.as_tensor(U),
        torch.as_tensor(Kg_j) if gains else None,
        torch.as_tensor(d_j) if gains else None, torch.as_tensor(alphas),
    )
    for g, w in zip(got, want):
        _close(g, w)


def test_forward_twin_mixed_fleet(jx):
    names = ["Unicycle4D", "Bike5D"]
    fleet_t, fields, mids, X, U, _ = _batch(names, seed=1)
    assert len(np.unique(mids)) == 2
    rng = np.random.default_rng(2)
    nxf, nuf = K * fleet_t.nx_p, K * fleet_t.nu_p
    Kg = 0.1 * rng.standard_normal((N, nuf, nxf, S))
    d = 0.1 * rng.standard_normal((N, nuf, S))
    jnp, pj = jx.jnp, jx.pj
    alphas = np.asarray(jx.dtl.ops.line_search_alphas(3, np.float64))
    fleet_j = jx.fleet(names)
    branch_row = pj._branch_row(fleet_j, jnp.asarray(mids), 3, jnp.float64)
    # Perturb the nominal so dx is nonzero.
    Xn = X + 0.05 * rng.standard_normal(X.shape) * (X != 0)
    want = pj.forward_pass_batched(
        fleet_j, jx.cost(fields), branch_row, jnp.asarray(Xn), jnp.asarray(U),
        jnp.asarray(Kg), jnp.asarray(d), jnp.asarray(alphas), interpret=True,
    )
    cost_t, mids_t = _port(fields, mids)
    got = bt.forward_pass_batched(
        fleet_t, cost_t, mids_t, torch.as_tensor(Xn), torch.as_tensor(U),
        torch.as_tensor(Kg), torch.as_tensor(d), torch.as_tensor(alphas),
    )
    for g, w in zip(got, want):
        _close(g, w)


def test_gauss_jordan_and_alphas(jx):
    from dpilqr_tpu.ops.ilqr import gauss_jordan_solve as gj_j
    from dpilqr_tpu_torch.ops.ilqr import gauss_jordan_solve as gj_t

    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 6))
    M = A @ A.T + 6 * np.eye(6)
    R = rng.standard_normal((6, 3))
    _close(gj_t(torch.as_tensor(M), torch.as_tensor(R)), gj_j(M, R))
    np.testing.assert_array_equal(
        line_search_alphas(10, torch.float64).numpy(),
        np.asarray(jx.dtl.ops.line_search_alphas(10, np.float64)),
    )
    # The batched twin's elimination agrees with the dense solve.
    Qx, Qu = bt._gj_solve_torch(
        torch.as_tensor(M)[None].clone(), torch.as_tensor(R)[None].clone(),
        torch.as_tensor(R[:, 0])[None].clone(),
    )
    _close(Qx[0], np.linalg.solve(M, R))
    _close(Qu[0], np.linalg.solve(M, R[:, 0]))


def test_compaction_schedule():
    assert bt.compaction_widths(100) == [100, 64, 32, 16]
    assert bt.compaction_widths(70) == [70, 48, 32, 16]
    assert bt.compaction_widths(16) == [16]
    assert bt.compaction_widths(5) == [5]


def test_cuda_wrappers_reject_what_they_cannot_take():
    fleet_t, fields, mids, X, U, mu = _batch(["Unicycle4D"])
    cost_t, mids_t = _port(fields, mids)
    Xt, Ut, mut = torch.as_tensor(X), torch.as_tensor(U), torch.as_tensor(mu)
    with pytest.raises(ValueError, match="CUDA"):
        bt.backward_pass_batched_cuda(fleet_t, cost_t, mids_t, Xt, Ut, mut)
    alphas = line_search_alphas(2, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        bt.forward_pass_batched_cuda(fleet_t, cost_t, mids_t, Xt, Ut, None,
                                     None, alphas)

    def trajectory(K_, nx=4, nu=2, dtype=torch.float64):
        return (torch.zeros((1, 2, K_, nx), dtype=dtype),
                torch.zeros((1, 1, K_, nu), dtype=dtype))

    # Flat states past 32 take the wide kernel, whose wrapper reaches its
    # CUDA check at nxf 48, at nxf 100 and at Quad6D's K=32 (nxf 192, nuf 96)
    # alike: no literal width stops it.  The first width the kernels' plan
    # cannot place (not even the vectors fit a block's shared memory) raises,
    # naming the plan.
    with pytest.raises(ValueError, match="wide"):
        bt.backward_pass_batched_cuda(fleet_t, cost_t, mids_t, *trajectory(12), mut)
    for K_ in (12, 25):
        with pytest.raises(ValueError, match="CUDA"):
            bt.backward_pass_batched_wide_cuda(fleet_t, cost_t, mids_t,
                                               *trajectory(K_), mut)
    for itemsize, dtype in ((4, torch.float32), (8, torch.float64)):
        assert riccati_plan(32, 6, 3, itemsize).tier == 2
        with pytest.raises(ValueError, match="CUDA"):
            bt.backward_pass_batched_wide_cuda(fleet_t, cost_t, mids_t,
                                               *trajectory(32, 6, 3, dtype), mut)

    def placed(K_):
        try:
            riccati_plan(K_, 4, 2, 8)
        except ValueError:
            return False
        return True

    first = next(K_ for K_ in range(1, 4000) if not placed(K_))
    assert first > 192 and placed(first - 1)
    with pytest.raises(ValueError, match="riccati_plan"):
        bt.backward_pass_batched_wide_cuda(fleet_t, cost_t, mids_t, *trajectory(first),
                                           mut)
    # The forward kernel: Quad12D at K=9 (nxf 108) reaches the CUDA check;
    # past one stage (a step's whole gain block) it takes the block in tiles
    # of rows, and the first K whose one warp's column beside a 4-row tile
    # does not fit raises, naming the plan, before any check of the inputs.
    fleet_q = dtt.homogeneous_fleet(dtt.QUAD_12D, 9, 0.1)
    Xq = torch.zeros((S, N + 1, 9, 12), dtype=torch.float64)
    Uq = torch.zeros((S, N, 9, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        bt.forward_pass_batched_cuda(fleet_q, cost_t, mids_t, Xq, Uq, None,
                                     None, alphas)

    def staged(K_):
        try:
            forward_plan(K_, 12, 4, 2, 8)
        except ValueError:
            return False
        return True

    first = next(K_ for K_ in range(1, 1000) if not staged(K_))
    assert first > 300 and staged(first - 1)
    assert forward_plan(first - 1, 12, 4, 2, 8).placement(
        4 * (first - 1)) == "tiles"
    one = torch.zeros((1,), dtype=torch.float64)
    with pytest.raises(ValueError, match="column_launch"):
        bt.forward_pass_batched_cuda(
            fleet_q, cost_t, mids_t,
            torch.zeros((1, 2, first, 12), dtype=torch.float64),
            torch.zeros((1, 1, first, 4), dtype=torch.float64), one, one, alphas)
    # Past the routing limit the kernels' own guard is the shared memory a
    # block may use: the sizing the wrappers consult answers any width and
    # raises only where nothing fits.
    assert forward_plan(32, 6, 3, 10, 4).buffers == 2
    assert forward_plan(64, 6, 3, 10, 8).placement(192) == "tiles"
    with pytest.raises(ValueError, match="shared memory"):
        riccati_plan(4000, 6, 3, 8)
    # Gains must lie in the kernels' memory order (or be copied into it).
    from dpilqr_tpu_torch.ops.cuda_build import check_tensors

    Kg = torch.zeros((N, 8, 16, S), dtype=torch.float64)
    with pytest.raises(ValueError, match="memory order"):
        check_tensors("forward_batched", {"Kg": Kg}, {"Kg": tuple(Kg.shape)},
                      Kg.dtype, Kg.device, layouts={"Kg": bt.GAIN_ORDER})
    check_tensors("forward_batched", {"Kg": bt.as_layout(Kg, bt.GAIN_ORDER)},
                  {"Kg": tuple(Kg.shape)}, Kg.dtype, Kg.device,
                  layouts={"Kg": bt.GAIN_ORDER})
    # "auto" resolves by device; unknown names are refused.
    assert bt.resolve_backend("auto", Xt) == "torch"
    with pytest.raises(ValueError):
        bt.resolve_backend("pallas", Xt)
    with pytest.raises(ValueError):
        dtt.SolverConfig(sweep_backend="xla")


# ---------------------------------------------------------------------------
# On a card: the CUDA kernels against their twins.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_kernels_match_twins(cuda_device, dtype):
    tol = {torch.float64: (1e-9, 1e-9), torch.float32: (2e-3, 1e-4)}[dtype]
    fleet_t, fields, mids, X, U, mu = _batch(["Unicycle4D", "Bike5D"], seed=3)
    cost_t, mids_t = _port(fields, mids, dtype, cuda_device)
    Xt = torch.as_tensor(X, dtype=dtype, device=cuda_device)
    Ut = torch.as_tensor(U, dtype=dtype, device=cuda_device)
    mut = torch.as_tensor(mu, dtype=dtype, device=cuda_device)
    Kg_t, d_t = bt.backward_pass_batched(fleet_t, cost_t, mids_t, Xt, Ut, mut, "torch")
    Kg_c, d_c = bt.backward_pass_batched(fleet_t, cost_t, mids_t, Xt, Ut, mut, "cuda")
    for a, b in ((Kg_c, Kg_t), (d_c, d_t)):
        assert float((a - b).abs().max()) <= tol[0] * float(b.abs().max())
    alphas = line_search_alphas(10, dtype, cuda_device)
    for gains in (True, False):
        args = (fleet_t, cost_t, mids_t, Xt, Ut, Kg_t if gains else None,
                d_t if gains else None, alphas)
        for a, b in zip(bt.forward_pass_batched(*args, backend="cuda"),
                        bt.forward_pass_batched(*args, backend="torch")):
            assert float((a - b).abs().max()) <= tol[1] * float(b.abs().max())
