"""The centralized solve's kernel wrappers (dpilqr_tpu_torch.ops.sweeps).

On the CPU: the wrappers refuse CPU tensors (no quiet twin), and
``ilqr_solve`` with ``sweep_backend="cuda"`` raises on them too.  The
``cuda`` cases hold ``csrc/backward_sweep.cu`` (K5, its inputs computed in
the kernel) and ``csrc/forward_sweep.cu`` (K4, with gains over 10 alphas and
as a rollout) against their plain PyTorch twins (``ops.ilqr._backward_pass``,
``_forward_pass``, ``_rollout_fn``) on a card, for a homogeneous, a mixed
and a single-agent fleet, and K5 on the fleets of ``chip_smoke.py`` phase 3c
(every model, every placement of its working set); they skip without one.
This file imports no JAX, so on a machine without it the ``cuda`` cases run
alone with ``python -m pytest tests/test_torch_sweeps.py -m cuda
--noconftest``.
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops import ilqr as It
from dpilqr_tpu_torch.ops import sweeps
from dpilqr_tpu_torch.ops.costs import cast_cost
from dpilqr_tpu_torch.ops.cuda_build import forward_plan, riccati_plan

torch.set_num_threads(1)

FLEETS = {
    "homogeneous": ["Unicycle4D"] * 4,
    "mixed": ["Unicycle4D", "DoubleInt4D", "Bike5D", "Car3D"],
    "single": ["Unicycle4D"],
}


def _problem(case, dtype, device, N=12):
    """Seeded start, goal and warm start; agents packed so proximity pairs
    are active: fleet, cost, X (rollout of U), U."""
    fleet = dtt.Fleet.from_names(FLEETS[case], 0.1)
    n, nx_p, nu_p = fleet.n_agents, fleet.nx_p, fleet.nu_p
    rng = np.random.default_rng(1)
    x0 = np.zeros((n, nx_p))
    x0[:, :2] = rng.uniform(-0.4, 0.4, (n, 2))
    xf = np.zeros((n, nx_p))
    xf[:, :2] = -x0[:, :2]
    cost = dtt.make_game_cost(
        xf, np.tile(np.eye(nx_p), (n, 1, 1)), np.tile(np.eye(nu_p), (n, 1, 1)),
        np.tile(1e3 * np.eye(nx_p), (n, 1, 1)), radius=0.5, dtype=dtype,
        device=device,
    )
    U = torch.as_tensor(0.1 * rng.normal(size=(N, n, nu_p)) * fleet.control_mask,
                        dtype=dtype, device=device)
    X, _ = It._rollout_fn(fleet.step, cost,
                          torch.as_tensor(x0, dtype=dtype, device=device), U)
    return fleet, cost, X, U


def test_sweep_wrappers_refuse_cpu_tensors():
    fleet, cost, X, U = _problem("homogeneous", torch.float64, "cpu")
    mu = torch.tensor(1.0, dtype=torch.float64)
    K, d = It._backward_pass(fleet.linearize, cost, X, U, mu)
    alphas = dtt.ops.line_search_alphas(3, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        sweeps.backward_pass_cuda(fleet, cost, X, U, mu)
    with pytest.raises(ValueError, match="CUDA"):  # before any shape check
        sweeps.backward_pass_cuda(fleet, cost, X[:, :2], U, mu)
    with pytest.raises(ValueError, match="CUDA"):
        sweeps.forward_pass_cuda(fleet, cost, X, U, K, d, alphas)
    with pytest.raises(ValueError, match="CUDA"):
        sweeps.rollout_cuda(fleet, cost, X[0], U)
    with pytest.raises(ValueError, match="CUDA"):
        dtt.ilqr_solve(fleet, cost, X[0], U0=U,
                       config=dtt.SolverConfig(sweep_backend="cuda"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLEETS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_sweeps_match_twins(cuda_device, case, dtype):
    tol = {torch.float64: (1e-9, 1e-9), torch.float32: (2e-3, 1e-4)}[dtype]
    fleet, cost, X, U = _problem(case, dtype, cuda_device)
    cost = cast_cost(cost, dtype)
    mu = torch.tensor(1.0, dtype=dtype, device=cuda_device)

    def close(got, want, t):
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= t * float(b.abs().max())

    K, d = It._backward_pass(fleet.linearize, cost, X, U, mu)
    close(sweeps.backward_pass_cuda(fleet, cost, X, U, mu), (K, d), tol[0])
    alphas = dtt.ops.line_search_alphas(10, dtype, cuda_device)
    close(sweeps.forward_pass_cuda(fleet, cost, X, U, K, d, alphas),
          It._forward_pass(fleet.step, cost, X, U, K, d, alphas), tol[1])
    close(sweeps.rollout_cuda(fleet, cost, X[0], U),
          It._rollout_fn(fleet.step, cost, X[0], U), tol[1])


K5_FLEETS = ("10 Unicycle4D", "9 models", "16 Quad6D", "32 Unicycle4D",
             "10 Unicycle4D N=200")


@pytest.mark.cuda
@pytest.mark.parametrize("name", K5_FLEETS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_k5_matches_twin_on_smoke_fleets(cuda_device, name, dtype):
    """K5 against its twin on the fleets of chip_smoke.py phase 3c, at the
    smoke's tolerances (f64 1e-9, f32 2e-3 relative to max|twin|)."""
    import chip_smoke as cs

    fleet, cost, X, U = cs.k5_problems(dtype, cuda_device)[name]
    mu = torch.tensor(1.0, dtype=dtype, device=cuda_device)
    tol = cs.TOL[dtype]["Kg"]
    got = sweeps.backward_pass_cuda(fleet, cost, X, U, mu)
    want = It._backward_pass(fleet.linearize, cost, X, U, mu)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


class _OnCard:
    """Stands in for a CUDA tensor of ``dtype``: the routing reads the
    device and the element size only."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, dtype):
        self.dtype = dtype

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_auto_routes_to_pscan_only_past_k5s_widest_tier(dtype):
    """ROADMAP C7: on the card "auto" takes the kernels wherever K5's plan
    places the problem (any horizon: no TPU crossover) and the scan past its
    widest tier, where an explicit "cuda" raises; CPU tensors take the
    twins on both sides of that line."""
    auto = dtt.SolverConfig()
    small = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 10, 0.1)
    # Past K5's widest tier (1,613 unicycles in float32, 806 in float64) and
    # within K4's plan (1,710 and 855): the forward sweep stays on the card.
    n_huge = 1650 if dtype == torch.float32 else 830
    huge = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n_huge, 0.1)
    card, cpu = _OnCard(dtype), torch.empty((), dtype=dtype)
    with pytest.raises(ValueError, match="no tier"):
        riccati_plan(n_huge, 4, 2, card.element_size())
    assert forward_plan(n_huge, 4, 2, 10, card.element_size()).warps >= 1
    assert riccati_plan(10, 4, 2, card.element_size()).tier == 0
    assert It.resolve_sweep_backend(auto, card, small) == "cuda"
    assert It.resolve_sweep_backend(auto, card, huge) == "pscan"
    assert It.resolve_sweep_backend(auto, cpu, small) == "torch"
    assert It.resolve_sweep_backend(auto, cpu, huge) == "torch"
    explicit = dtt.SolverConfig(sweep_backend="cuda")
    assert It.resolve_sweep_backend(explicit, card, small) == "cuda"
    with pytest.raises(ValueError, match="no tier"):
        It.resolve_sweep_backend(explicit, card, huge)
    scan = dtt.SolverConfig(sweep_backend="pscan")
    assert It.resolve_sweep_backend(scan, card, small) == "pscan"
