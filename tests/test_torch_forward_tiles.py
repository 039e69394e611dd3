"""The forward kernels (K2 ``csrc/forward_batched.cu``, K4
``csrc/forward_sweep.cu``) at every width the backward kernels place: a
step's gain block whole where it fits, else in tiles of rows
(``column_launch`` in ``csrc/plan.h``, read through
``cuda_build.forward_plan``), and the resolvers that refuse a width no
kernel places before any launch.

On the CPU: the plan's placement at the widths that once raised (the
centralized solve of 100 and 500 Unicycle4D and of 64 Quad6D, the decomposed
Quad12D at K=32, Quad6D at K=64, Unicycle4D at K=64 and 128), its raise past
one warp's column beside a 4-row tile, and ``ops.ilqr.resolve_sweep_backend``
and ``solve_subproblems_batched``'s check on each side of K5's limit, of K3's
and of the forward kernels'.  On a card (``cuda``): tiled K2 and K4 against
their twins, and tiles forced at widths where a whole block fits against the
whole block's bits.
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops import ilqr as It
from dpilqr_tpu_torch.ops import sweeps
from dpilqr_tpu_torch.ops.cuda_build import SMEM_LIMIT, forward_plan, riccati_plan

UNI, Q6, Q12 = (4, 2), (6, 3), (12, 4)

# (K, (nx, nu), itemsize, n_alpha) -> (chunks, warps, buffers, rows, bytes):
# the placements of the widths that raised before the tiles, 10 alphas (5
# warps a CTA on 2 CTAs) unless noted.
PLACED = {
    (100, UNI, 4, 10): (2, 5, 2, 52, 192800),  # centralized, 100 Unicycle4D
    (100, UNI, 8, 10): (2, 5, 2, 28, 232000),
    (100, UNI, 8, 2): (1, 2, 2, 28, 208000),
    (500, UNI, 4, 10): (2, 5, 2, 4, 196000),
    (500, UNI, 8, 10): (4, 3, 1, 4, 216000),  # fewer warps, one buffer
    (64, Q6, 4, 10): (2, 5, 2, 64, 221952),  # centralized, 64 Quad6D
    (64, Q6, 8, 10): (2, 5, 2, 28, 222720),  # also the decomposed Quad6D at K=64
    (32, Q12, 8, 10): (2, 5, 2, 28, 218112),  # decomposed
    (32, Q12, 8, 2): (1, 2, 2, 32, 221184),
    (64, UNI, 8, 10): (2, 5, 2, 44, 214016),
    (128, UNI, 4, 10): (2, 5, 2, 44, 214016),
    (128, UNI, 4, 2): (1, 2, 2, 52, 231424),
}


@pytest.mark.parametrize("case", sorted(PLACED), ids=lambda c: "K{}nx{}it{}a{}".format(
    c[0], c[1][0], c[2], c[3]))
def test_mirror_places_the_widths_that_raised(case):
    K, (nx, nu), itemsize, n_alpha = case
    plan = forward_plan(K, nx, nu, n_alpha, itemsize)
    assert plan.placement(K * nu) == "tiles"
    assert tuple(plan) == PLACED[case]
    assert plan.rows % 4 == 0 and plan.rows < K * nu
    assert plan.chunks * plan.warps >= n_alpha and plan.nbytes <= SMEM_LIMIT
    # With room for it, the same problem takes its whole gain block.
    assert forward_plan(K, nx, nu, n_alpha, itemsize, limit=1 << 40).placement(
        K * nu) == "stages"


def test_whole_blocks_stay_and_tiles_can_be_forced():
    # Where a whole block fits the placement is the one before tiles...
    plan = forward_plan(8, 4, 2, 10, 4)
    assert plan.placement(16) == "stages" and (plan.buffers, plan.rows) == (2, 16)
    assert forward_plan(32, 12, 4, 10, 4)[2:4] == (1, 128)
    # ... and max_rows forces tiles of at most that many rows (a multiple of
    # 4), evened out over the block: the smoke's and the cuda tests' check.
    assert forward_plan(8, 4, 2, 10, 4, max_rows=4)[2:4] == (2, 4)
    assert forward_plan(16, 6, 3, 10, 8, max_rows=8)[2:4] == (2, 8)
    assert forward_plan(16, 6, 3, 10, 8, max_rows=20)[2:4] == (2, 16)
    assert forward_plan(8, 4, 2, 10, 4, max_rows=16).placement(16) == "stages"
    # Without gains a CTA holds its columns only.
    assert forward_plan(500, 4, 2, 1, 8, gains=False)[:4] == (1, 1, 1, 0)
    assert forward_plan(8, 4, 2, 0, 4) == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("itemsize,last", [(4, 1709), (8, 854)], ids=["f32", "f64"])
def test_mirror_raises_past_one_column_beside_a_four_row_tile(itemsize, last):
    plan = forward_plan(last, 4, 2, 10, itemsize)
    assert (plan.warps, plan.buffers, plan.rows) == (1, 1, 4)
    with pytest.raises(ValueError, match="column_launch"):
        forward_plan(last + 1, 4, 2, 10, itemsize)
    with pytest.raises(ValueError, match="column_launch"):
        forward_plan(last + 1, 4, 2, 1, itemsize)


class _OnCard:
    """Stands in for a CUDA tensor of ``dtype``: the routing reads the
    device and the element size only."""

    is_cuda = True

    def __init__(self, dtype):
        self.dtype = dtype

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()


# Unicycle4D fleets: the last K5 places, the first it does not, the last K4
# places, the first it does not.
CENTRAL = {torch.float32: (1612, 1613, 1709, 1710), torch.float64: (805, 806, 854, 855)}


@pytest.mark.parametrize("dtype", sorted(CENTRAL, key=str), ids=["f32", "f64"])
def test_centralized_resolver_on_each_side_of_both_plans(dtype):
    k5, past_k5, k4, past_k4 = (dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
                                for n in CENTRAL[dtype])
    card, cpu = _OnCard(dtype), torch.empty((), dtype=dtype)
    auto, cuda = dtt.SolverConfig(), dtt.SolverConfig(sweep_backend="cuda")
    scan = dtt.SolverConfig(sweep_backend="pscan")
    assert It.resolve_sweep_backend(auto, card, k5) == "cuda"
    assert It.resolve_sweep_backend(auto, card, past_k5) == "pscan"
    assert It.resolve_sweep_backend(auto, card, k4) == "pscan"
    assert It.resolve_sweep_backend(scan, card, k4) == "pscan"
    with pytest.raises(ValueError, match="no tier"):
        It.resolve_sweep_backend(cuda, card, past_k5)
    # Past K4's plan nothing solves the fleet on the card: every backend
    # that would launch K4 raises, naming the plan (an explicit "cuda" K5's,
    # which it meets first).
    for cfg in (auto, scan):
        with pytest.raises(ValueError, match="column_launch"):
            It.resolve_sweep_backend(cfg, card, past_k4)
    with pytest.raises(ValueError, match="riccati_plan"):
        It.resolve_sweep_backend(cuda, card, past_k4)
    # CPU tensors take the twins, which have no such limit.
    assert It.resolve_sweep_backend(auto, cpu, past_k4) == "torch"
    assert It.resolve_sweep_backend(scan, cpu, past_k4) == "pscan"


# Quad12D subproblems: K2's plan ends before K3's (their first unplaced K).
DECOMPOSED = {torch.float32: (606, 632), torch.float64: (303, 316)}


@pytest.mark.parametrize("dtype", sorted(DECOMPOSED, key=str), ids=["f32", "f64"])
def test_batched_solve_checks_both_plans_before_any_launch(dtype):
    past_k2, past_k3 = DECOMPOSED[dtype]
    item = torch.empty((), dtype=dtype).element_size()
    riccati_plan(past_k2, 12, 4, item)
    with pytest.raises(ValueError, match="riccati_plan"):
        riccati_plan(past_k3, 12, 4, item)
    cuda = dtt.SolverConfig(sweep_backend="cuda", n_lqr_iter=2)

    def solve(K, cfg=cuda):
        fleet = dtt.homogeneous_fleet(dtt.QUAD_12D, K, 0.1)
        eye = np.eye(12)
        cost = dtt.make_game_cost(np.zeros((K, 12)), np.tile(eye, (K, 1, 1)),
                                  np.tile(np.eye(4), (K, 1, 1)), np.tile(eye, (K, 1, 1)),
                                  radius=0.5, dtype=dtype, device="cpu")
        sub = type(cost)(*(a[None] for a in cost))
        N = 2
        return bt.solve_subproblems_batched(
            fleet, cfg, sub, torch.zeros((1, K, 12), dtype=dtype),
            torch.zeros((1, N, K, 4), dtype=dtype), torch.zeros((1, K), dtype=torch.int32),
            torch.ones(1, dtype=torch.bool))

    # Within both plans the first thing to refuse CPU tensors is K2's
    # wrapper, at the warm start's rollout; past K2's plan, and past K3's,
    # the check before the first iteration names the plan.
    with pytest.raises(ValueError, match="CUDA tensors"):
        solve(past_k2 - 1)
    with pytest.raises(ValueError, match="column_launch"):
        solve(past_k2)
    with pytest.raises(ValueError, match="riccati_plan"):
        solve(past_k3)
    # The twins check nothing and solve.
    res = solve(3, dtt.SolverConfig(sweep_backend="torch", n_lqr_iter=2))
    assert res.X.shape == (1, 3, 3, 12)


# ---------------------------------------------------------------------------
# On a card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want, dtype):
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_tiled_forward_kernels_match_twins_and_staged_bits(cuda_device, dtype):
    dev = cuda_device
    rng = np.random.default_rng(7)
    # K4 with gains at 100 Unicycle4D: the block in tiles (no stage fits).
    n, N = 100, 8
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
    x0 = np.zeros((n, 4))
    x0[:, :2] = np.stack([np.arange(n) % 10, np.arange(n) // 10], -1) * 1.25
    xf = x0 + np.array([1.0, 0.0, 0.0, 0.0])
    cost = dtt.make_game_cost(xf, np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
                              np.tile(10 * np.eye(4), (n, 1, 1)), radius=0.5, dtype=dtype,
                              device=dev)
    U = torch.as_tensor(rng.uniform(size=(N, n, 2)) * 0.1, dtype=dtype, device=dev)
    X = It._rollout_fn(fleet.step, cost, torch.as_tensor(x0, dtype=dtype, device=dev), U)[0]
    Kb, db = It._backward_pass(fleet.linearize, cost, X, U,
                               torch.tensor(1.0, dtype=dtype, device=dev))
    alphas = It.line_search_alphas(10, dtype, dev)
    fw = (cost, X, U, Kb, db, alphas)
    assert forward_plan(n, 4, 2, 10, X.element_size()).placement(2 * n) == "tiles"
    _close(sweeps.forward_pass_cuda(fleet, *fw), It._forward_pass(fleet.step, *fw), dtype)
    # K2 and K4 at widths where a whole block fits: forced tiles give its bits.
    fleet10 = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 10, 0.1)
    cost10 = type(cost)(*(a[:10] if a.ndim else a for a in cost))
    U10 = U[:, :10].contiguous()
    X10 = It._rollout_fn(fleet10.step, cost10, X[0, :10].contiguous(), U10)[0]
    K10, d10 = It._backward_pass(fleet10.linearize, cost10, X10, U10,
                                 torch.tensor(1.0, dtype=dtype, device=dev))
    fw10 = (cost10, X10, U10, K10, d10, alphas)
    whole = sweeps.forward_pass_cuda(fleet10, *fw10)
    for rows in (4, 8):
        assert all(torch.equal(a, b) for a, b in zip(
            sweeps.forward_pass_cuda(fleet10, *fw10, max_rows=rows), whole))
    S, Kw = 6, 10
    sub = type(cost10)(*(a[None].expand(S, *a.shape).contiguous() for a in cost10))
    Xs = X10[None].expand(S, -1, -1, -1).contiguous()
    Us = U10[None].expand(S, -1, -1, -1).contiguous()
    mids = torch.zeros((S, Kw), dtype=torch.int32, device=dev)
    Kg = K10[..., None].expand(-1, -1, -1, S)
    d = d10[..., None].expand(-1, -1, S)
    for n_alpha in (2, 10):
        fa = (fleet10, sub, mids, Xs, Us, Kg, d, alphas[:n_alpha])
        whole = bt.forward_pass_batched_cuda(*fa)
        _close(whole, bt.forward_pass_batched_torch(*fa), dtype)
        for rows in (4, 12):
            assert all(torch.equal(a, b) for a, b in zip(
                bt.forward_pass_batched_cuda(*fa, max_rows=rows), whole))
