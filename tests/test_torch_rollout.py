"""The plain rollout of the port: which function serves which device, its two
plain versions against each other and against the JAX package, and on a card
the kernel ``csrc/forward_sweep.cu`` (K4) against its plain versions.

On the CPU (float64 unless stated): ``ops.ilqr.rollout`` picks by the
tensors' device (``rollout_backend``): the kernel branch for a CUDA device,
``_rollout_fn`` / ``_rollout_batched_cost`` for the CPU, tested on the
predicate and on the dispatch, with no launch.  ``_rollout_fn`` accumulates J
step by step (as the kernel does), ``_rollout_batched_cost`` sums it
time-batched (as ``dpilqr_tpu.ops.ilqr._rollout_batched_cost`` does): on a
seeded fleet of 12 agents over N = 10 steps, homogeneous and mixed, X agrees
to 1e-12 and J to 1e-12 relative in float64, 1e-5 in float32: the stated
tolerance of the two summation orders.  The forward kernels' shared-memory
plan (``cuda_build.forward_plan``) is held at K4's shapes (K = n agents).

The ``cuda`` cases run K4 with gains (n = 3, 10, 24; 1, 2, 10 alphas) and
without (n = 1 to 500; Unicycle4D, Quad6D, Quad12D, a mixed fleet with
Bike5D's one substep, masked agents, ``n_pos_eval`` 2 and 3) against the plain
versions, float64 to 1e-9 and float32 to 1e-4 relative, J bit-equal in two
runs; they skip without a card and need no JAX (``-m cuda --noconftest``; the
JAX side is imported by the ``jx`` fixture).
"""

import types

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops import ilqr as It
from dpilqr_tpu_torch.ops import sweeps
from dpilqr_tpu_torch.ops.cuda_build import SMEM_LIMIT, forward_plan

torch.set_num_threads(1)

MIXED = ["DoubleInt4D", "Car3D", "Bike5D", "Unicycle4D"]
FLEETS = {
    "unicycles": ["Unicycle4D"],
    "mixed": MIXED,
    "quad6d": ["Quad6D"],
    "quad12d": ["Quad12D"],
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.ops import ilqr as I
    from dpilqr_tpu.ops.costs import GameCost

    return types.SimpleNamespace(dtl=dtl, I=I, jnp=jnp, GameCost=GameCost)


def _fleet_problem(kind, n, N, dtype, device="cpu", seed=0, masked=(), n_pos_eval=None,
                   spread=0.6):
    """A seeded fleet of ``n`` agents packed so that pairs lie inside the
    radius: fleet, cost fields (numpy), x0 ``(n, nx_p)``, U ``(N, n, nu_p)``
    as tensors.  ``masked`` agents get ``agent_mask`` 0."""
    names = (FLEETS[kind] * n)[:n]
    fleet = dtt.Fleet.from_names(names, 0.1)
    nx_p, nu_p = fleet.nx_p, fleet.nu_p
    rng = np.random.default_rng(seed)
    n_pos = 3 if nx_p >= 6 else 2
    x0 = np.zeros((n, nx_p))
    x0[:, :n_pos] = rng.uniform(-spread, spread, (n, n_pos)) * max(1.0, n ** (1 / n_pos) / 2)
    xf = np.zeros((n, nx_p))
    xf[:, :n_pos] = -x0[:, :n_pos]
    mask = np.ones((n,))
    mask[list(masked)] = 0.0
    scale = 1e-7 if kind == "quad12d" else 0.05
    U = scale * rng.normal(size=(N, n, nu_p)) * fleet.control_mask
    if kind == "quad6d":
        U[..., 0] += 9.80665
    if kind == "quad12d":
        U[..., 3] += 9.80665 * 63 / 2000
    fields = dict(
        xf=xf, Q=np.tile(np.eye(nx_p), (n, 1, 1)), R=np.tile(np.eye(nu_p), (n, 1, 1)),
        Qf=np.tile(100.0 * np.eye(nx_p), (n, 1, 1)), radius=np.asarray(0.5),
        n_pos=np.full((n,), n_pos, np.int32), agent_mask=mask,
        prox_weight=np.asarray(200.0), ref_weight=np.asarray(1.0),
        n_pos_eval=np.full((n,), n_pos if n_pos_eval is None else n_pos_eval, np.int32),
    )
    from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy

    cost = game_cost_from_numpy(fields, device, dtype)
    return (fleet, fields, cost, torch.as_tensor(x0, dtype=dtype, device=device),
            torch.as_tensor(U, dtype=dtype, device=device))


def test_rollout_backend_picks_by_device():
    assert It.rollout_backend(torch.device("cuda", 0)) == "cuda"
    assert It.rollout_backend("cuda:1") == "cuda"
    assert It.rollout_backend(torch.device("cpu")) == "torch"
    assert It.rollout_backend(torch.zeros(1).device) == "torch"


def test_rollout_takes_the_plain_versions_on_cpu_tensors():
    fleet, _, cost, x0, U = _fleet_problem("mixed", 6, 5, torch.float64)
    for flag, plain in ((False, It._rollout_fn), (True, It._rollout_batched_cost)):
        X, J = It.rollout(fleet, cost, x0, U, time_batched_cost=flag)
        Xw, Jw = plain(fleet.step, cost, x0, U)
        assert torch.equal(X, Xw) and torch.equal(J, Jw)


def test_rollout_takes_the_kernel_branch_for_a_cuda_device(monkeypatch):
    """The dispatch, without a launch: told that the tensors lie on a card,
    ``rollout`` calls the kernel's wrapper (with the cost cast and contiguous
    tensors) and neither plain version; the wrapper's failure is not caught."""
    fleet, _, cost, x0, U = _fleet_problem("unicycles", 4, 5, torch.float64)
    calls = []

    def fake_kernel(fleet_, cost_, x0_, U_):
        calls.append((x0_.is_contiguous(), U_.is_contiguous(), cost_.xf.dtype))
        return "X", "J"

    def no_plain(*a, **k):
        raise AssertionError("a plain rollout ran for a CUDA device")

    monkeypatch.setattr(It, "rollout_backend", lambda device: "cuda")
    monkeypatch.setattr(sweeps, "rollout_cuda", fake_kernel)
    monkeypatch.setattr(It, "_rollout_fn", no_plain)
    monkeypatch.setattr(It, "_rollout_batched_cost", no_plain)
    for flag in (False, True):
        assert It.rollout(fleet, cost, x0, U.transpose(0, 1).contiguous().transpose(0, 1),
                          time_batched_cost=flag) == ("X", "J")
    assert calls == [(True, True, torch.float64)] * 2

    def broken(*a):
        raise RuntimeError("forward_sweep kernel failed: cudaError 1")

    monkeypatch.setattr(sweeps, "rollout_cuda", broken)
    with pytest.raises(RuntimeError, match="forward_sweep"):
        It.rollout(fleet, cost, x0, U)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["unicycles", "mixed"])
def test_plain_rollouts_agree_with_each_other_and_with_jax(jx, kind, dtype):
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    fleet, fields, cost, x0, U = _fleet_problem(kind, 12, 10, dtype)
    from dpilqr_tpu_torch.ops.costs import proximity_cost

    X_fn, J_fn = It._rollout_fn(fleet.step, cost, x0, U)
    X_b, J_b = It._rollout_batched_cost(fleet.step, cost, x0, U)
    assert float(proximity_cost(cost, X_fn[0])) > 0.0  # pairs are active
    assert torch.equal(X_fn, X_b)
    assert abs(float(J_fn) - float(J_b)) <= tol * abs(float(J_b))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    jnp = jx.jnp
    fleet_j = jx.dtl.Fleet(tuple(getattr(jx.dtl, _spec_name(s.name)) for s in fleet.specs), 0.1)
    cost_j = jx.GameCost(**{
        k: jnp.asarray(v if v.dtype == np.int32 else v.astype(np_dtype))
        for k, v in fields.items()})
    X_j, J_j = jx.I._rollout_batched_cost(
        fleet_j.step, cost_j, jnp.asarray(x0.numpy()), jnp.asarray(U.numpy()))
    assert np.asarray(X_j).dtype == np_dtype
    scale = float(X_fn.abs().max())
    assert float(np.abs(X_fn.numpy() - np.asarray(X_j)).max()) <= tol * scale
    for J in (J_fn, J_b):
        assert abs(float(J) - float(J_j)) <= tol * abs(float(J_j))


def _spec_name(model: str) -> str:
    """``Unicycle4D`` -> ``UNICYCLE_4D``, the packages' spec constants."""
    head = model.rstrip("0123456789D")
    out = "".join("_" + c if c.isupper() and i else c for i, c in enumerate(head))
    return f"{out.upper()}_{model[len(head):]}"


def test_forward_sweep_shapes_fit_the_shared_memory_mirror():
    # K4 with gains is the column routine at one problem with K = n slots:
    # the centralized shapes stage two gain blocks, in either type.
    for n in (3, 10, 24):
        for n_alpha in (1, 2, 10):
            for itemsize in (4, 8):
                plan = forward_plan(n, 4, 2, n_alpha, itemsize)
                assert plan.buffers == 2 and plan.placement(2 * n) == "stages"
                assert 0 < plan.nbytes <= SMEM_LIMIT
    # A step's gain block of 100 unicycles (200 x 400 values) fits no block:
    # it comes in tiles of rows; past one warp's column beside a 4-row tile
    # the wrapper says so before it asks for a card.  The plain rollout of
    # the same fleet has no gains and no such limit.
    assert forward_plan(100, 4, 2, 10, 4).placement(200) == "tiles"
    with pytest.raises(ValueError, match="column_launch"):
        forward_plan(2000, 4, 2, 10, 4)
    fleet, _, cost, x0, U = _fleet_problem("unicycles", 100, 2, torch.float32)
    X = x0[None].expand(3, -1, -1).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        sweeps.forward_pass_cuda(fleet, cost, X, U, torch.zeros((2, 200, 400)),
                                 torch.zeros((2, 200)), torch.ones((10,)))
    with pytest.raises(ValueError, match="rollout_cuda"):
        sweeps.forward_pass_cuda(fleet, cost, X, U, None, None, torch.ones((1,)))
    with pytest.raises(ValueError, match="CUDA"):
        sweeps.rollout_cuda(fleet, cost, x0, U)
    assert sweeps.ROLLOUT_COST_PARTS >= 1


# ---------------------------------------------------------------------------
# On a card: K4 against its plain versions.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _within(got, want, tol):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


ROLLOUT_CASES = {
    "1-unicycle": dict(kind="unicycles", n=1),
    "10-unicycles": dict(kind="unicycles", n=10),
    "100-unicycles": dict(kind="unicycles", n=100),
    "500-unicycles": dict(kind="unicycles", n=500),
    "27-quad6d": dict(kind="quad6d", n=27),
    "27-quad6d-npos2": dict(kind="quad6d", n=27, n_pos_eval=2),
    "8-quad12d": dict(kind="quad12d", n=8),
    "12-mixed": dict(kind="mixed", n=12),
    "40-mixed-masked": dict(kind="mixed", n=40, masked=(0, 7, 39)),
    "10-unicycles-npos3": dict(kind="unicycles", n=10, n_pos_eval=3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
def test_cuda_rollout_matches_plain_versions(cuda_device, case, dtype):
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    fleet, _, cost, x0, U = _fleet_problem(N=20, dtype=dtype, device=cuda_device,
                                           **ROLLOUT_CASES[case])
    got = sweeps.rollout_cuda(fleet, cost, x0, U)
    assert got[0].shape == (21, fleet.n_agents, fleet.nx_p) and got[1].shape == ()
    for plain in (It._rollout_fn, It._rollout_batched_cost):
        _within(got, plain(fleet.step, cost, x0, U), tol)
    again = sweeps.rollout_cuda(fleet, cost, x0, U)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    # The public rollout and the stitched cost take the same kernel.
    for flag in (False, True):
        X, J = It.rollout(fleet, cost, x0, U, time_batched_cost=flag)
        assert torch.equal(J, got[1]) and torch.equal(X, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n_alpha", [1, 2, 10])
@pytest.mark.parametrize("n", [3, 10, 24])
def test_cuda_forward_sweep_with_gains_matches_twin(cuda_device, n, n_alpha, dtype):
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    fleet, _, cost, x0, U = _fleet_problem("mixed" if n == 10 else "unicycles", n, 20,
                                           dtype, cuda_device, seed=n)
    X, _ = It._rollout_fn(fleet.step, cost, x0, U)
    K, d = It._backward_pass(fleet.linearize, cost, X, U,
                             torch.tensor(1.0, dtype=dtype, device=cuda_device))
    # Gains scaled to max|K| = 0.1, so that the closed loop of these packed
    # fleets stays well conditioned; the nominal is perturbed so that dx != 0.
    s = 0.1 / float(K.abs().max())
    K, d = s * K, s * d
    Xn = X + 0.01 * torch.as_tensor(
        np.random.default_rng(1).normal(size=tuple(X.shape)), dtype=dtype,
        device=cuda_device) * (X != 0)
    Xn[0] = X[0]
    alphas = dtt.ops.line_search_alphas(n_alpha, dtype, cuda_device)
    got = sweeps.forward_pass_cuda(fleet, cost, Xn, U, K, d, alphas)
    _within(got, It._forward_pass(fleet.step, cost, Xn, U, K, d, alphas), tol)
    assert torch.equal(got[0][:, 0], Xn[0].expand(n_alpha, -1, -1))
