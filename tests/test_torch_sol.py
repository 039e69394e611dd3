"""The port's speed-of-light accounting (dpilqr_tpu_torch.utils.sol).

On the CPU: the work counts against ``dpilqr_tpu.utils.sol``'s, where each
term that exists only on the TPU is written out here (JAX count minus those
terms equals the port's count, exactly); the byte counts against the summed
``numel * itemsize`` of the tensors the kernels' wrappers take and return,
built at a small shape through the same torch preparation; ``kernel_sol``
with monkeypatched ceilings; and the probes' plain PyTorch versions against
a numpy transcription of the three TPU kernel bodies (float32, rel 1e-6: the
same chain of float32 operations, rounded alike up to the libm's sine).

The ``cuda`` cases hold the three probe kernels against their plain versions
on a card, run ``sol_report`` and skip without a card.  They need no JAX
(the JAX side is imported by the ``jsol`` fixture), so they also run with
``python -m pytest tests/test_torch_sol.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.models.specs import MODEL_REGISTRY
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops import ilqr as It
from dpilqr_tpu_torch.utils import sol

torch.set_num_threads(1)

# (K, nx_p, nu_p, n_alpha, substeps, f_flops_per_slot)
SHAPES = [
    (8, 4, 2, 10, 5, 2),  # the 100-agent main path: Unicycle4D, K = 8
    (4, 4, 2, 2, 5, 2),  # its two-alpha probe stage at K = 4
    (16, 6, 3, 10, 5, 3),  # Quad6D at K = 16: nxf 96, nuf 48
    (8, 12, 4, 10, 5, 83),  # Quad12D at K = 8: nxf 96
    (10, 4, 2, 10, 5, 2),  # the 10-agent centralized problem, K = n
    (1, 5, 2, 3, 1, 3),  # one Bike5D slot, one RK4 substep
]


@pytest.fixture(scope="module")
def jsol():
    from dpilqr_tpu.utils import sol as jax_sol

    return jax_sol


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_work_counts_are_the_jax_counts_less_the_tpu_only_terms(jsol, shape):
    K, nx_p, nu_p, n_alpha, substeps, f_flops = shape
    nxf, nuf = K * nx_p, K * nu_p
    C = K * n_alpha

    # Backward.  TPU only: the dense ``mu * eye`` multiply-add over all of P
    # (the port adds mu to the nxf diagonal entries), and the one-hot blends
    # that restore the pivot row of the in-kernel Gauss-Jordan solve, 4 w
    # per pivot over the (nuf + nxf + 1)-wide augmented system.
    dense_mu_pass = 2 * nxf * nxf - nxf
    one_hot_blends = nuf * 4 * (nuf + nxf + 1)
    assert sol.backward_step_flops(K, nx_p, nu_p) == (
        jsol.backward_step_flops(K, nx_p, nu_p) - dense_mu_pass - one_hot_blends)

    # Forward.  TPU only: the 0/1 matmul that extracts each slot's rows of
    # du; and, in the bytes, the nominal X and U rows and d tiled once per
    # alpha (the port's kernels read them once for all alphas).
    row_extraction = 2 * nu_p * nuf * C
    assert sol.forward_step_flops(K, nx_p, nu_p, n_alpha, substeps, f_flops) == (
        jsol.forward_step_flops(K, nx_p, nu_p, n_alpha, substeps, f_flops)
        - row_extraction)
    tiled_per_alpha = (n_alpha - 1) * (nxf + 2 * nuf)
    for nbytes in (4, 8):
        assert sol.forward_step_hbm_bytes(K, nx_p, nu_p, n_alpha, nbytes) == (
            jsol.forward_step_hbm_bytes(K, nx_p, nu_p, n_alpha, nbytes)
            - tiled_per_alpha * nbytes)
    for f_trig in (2, 7):
        assert sol.forward_step_trig_ops(K, nx_p, nu_p, n_alpha, substeps, f_trig) == (
            jsol.forward_step_trig_ops(K, nx_p, nu_p, n_alpha, substeps, f_trig))
    assert sol.pscan_sweep_flops(50, nxf) == jsol.pscan_sweep_flops(50, nxf)


def test_model_work_table():
    # Unicycle4D: x2 cos(x3), x2 sin(x3); partials -x2 sin(x3), x2 cos(x3).
    assert sol.model_work("Unicycle4D") == (2, 2, 5, 3)
    assert sol.model_work("Quad6D") == (3, 2, 5, 6)
    assert sol.model_work("Quad12D") == (83, 7, 5, 135)
    assert sol.model_work("Bike5D") == (3, 3, 1, 6)
    # Every model has a row, and the substep counts are the model specs' own.
    assert set(sol.MODEL_WORK) == {s.name for s in MODEL_REGISTRY}
    for name, work in sol.MODEL_WORK.items():
        spec = dtt.Fleet.from_names([name], 0.1).specs[0]
        assert work.substeps == spec.rk4_substeps
        # Models with no trigonometry have constant Jacobians.
        assert (work.f_trig == 0) == (work.jac_flops == 0)
    with pytest.raises(KeyError, match="no work count"):
        sol.model_work("Unicycle3D")
    with pytest.raises(KeyError):
        sol.sweep_work("forward", 5, 2, 5, 2, 3, 2, model="Unicycle3D")
    # A mixed batch: the mean of its slots' counts.
    mixed = sol.sweep_work("forward", 5, 2, 5, 2, 3, 2, model=("Bike5D", "Car3D"))
    one = [sol.sweep_work("forward", 5, 2, 5, 2, 3, 2, model=m) for m in ("Bike5D", "Car3D")]
    assert mixed[0] == (one[0][0] + one[1][0]) // 2 and mixed[2] == one[0][2]


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _batched_problem(dtype, S=3, K=2, N=5, seed=0):
    """A batch of S subproblems of K unicycle slots and its nominal
    trajectory, on the CPU."""
    rng = np.random.default_rng(seed)
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, K, 0.1)
    xf = rng.normal(size=(K, 4))
    cost = dtt.make_game_cost(
        xf, np.tile(np.eye(4), (K, 1, 1)), np.tile(np.eye(2), (K, 1, 1)),
        np.tile(1e2 * np.eye(4), (K, 1, 1)), radius=0.5, dtype=dtype, device="cpu")
    cost_b = type(cost)(*(a[None].expand(S, *a.shape).contiguous() for a in cost))
    X = torch.as_tensor(0.3 * rng.normal(size=(S, N + 1, K, 4)), dtype=dtype)
    U = torch.as_tensor(0.1 * rng.normal(size=(S, N, K, 2)), dtype=dtype)
    mids = torch.zeros((S, K), dtype=torch.int32)
    return fleet, cost, cost_b, mids, X, U


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_byte_counts_equal_the_wrappers_tensors(dtype):
    S, K, N, n_alpha = 3, 2, 5, 4
    nbytes = torch.empty((), dtype=dtype).element_size()
    fleet, cost, cost_b, mids, X, U = _batched_problem(dtype, S, K, N)
    mu = torch.ones((S,), dtype=dtype)

    # K1 / K3: the arguments the wrapper hands its kernel (the trajectory,
    # the per-slot cost, the slots' branch indices, the unique models' ids,
    # dt and mu; no Jacobian or Hessian), and the kernel's outputs (the
    # plain version returns the same two tensors).  Their work: each
    # subproblem's recursion and inputs, as K5's.
    Kg, d = bt.backward_pass_batched(fleet, cost_b, mids, X, U, mu, "torch")
    c = cost_b
    ids = torch.zeros((1,), dtype=torch.int32)
    ins = (X, U, c.xf, c.Q, c.R, c.Qf, c.agent_mask, c.ref_weight, c.radius,
           c.prox_weight, c.n_pos, mids, ids, torch.ones((1,), dtype=dtype), mu)
    prep, prep_trig = sol.sweep_prep_flops(K, 4, 2)
    for family in ("backward", "backward_wide"):
        fl, trig, by = sol.sweep_work(family, N, K, 4, 2, S, n_alpha,
                                      dtype_bytes=nbytes)
        assert by == _nbytes(*ins, Kg, d)
        assert trig == N * S * prep_trig
        assert fl == S * ((sol.backward_step_flops(K, 4, 2) + prep) * N
                          + sol.sweep_prep_flops(K, 4, 2, terminal=True)[0]
                          + sol.sweep_fixed_flops(K, 4, 2))

    # K2: forward_pass_batched_cuda's ``ins`` and its three outputs.
    alphas = It.line_search_alphas(n_alpha, dtype)
    tables = bt._slot_tables(fleet, mids, dtype)
    c = cost_b
    outs = bt.forward_pass_batched_torch(fleet, cost_b, mids, X, U, Kg, d, alphas)
    fwd_ins = (X, U, Kg, d, alphas, *tables, c.xf, c.Q, c.R, c.Qf, c.agent_mask,
               c.ref_weight, c.radius, c.prox_weight, c.n_pos_eval)
    fl, trig, by = sol.sweep_work("forward", N, K, 4, 2, S, n_alpha,
                                  dtype_bytes=nbytes)
    assert by == _nbytes(*fwd_ins, *outs)
    assert trig == 5 * 4 * 2 * K * n_alpha * N * S

    # K5: backward_pass_cuda's arguments, from their shapes (one problem,
    # K = n agents): the trajectory, the cost's fields, the model ids, dt and
    # mu in, the gains out; no Jacobian or Hessian goes through memory.
    X1, U1 = X[0].contiguous(), U[0].contiguous()
    K5, d5 = It._backward_pass(fleet.linearize, cost, X1, U1,
                               torch.tensor(1.0, dtype=dtype))
    scalar = torch.ones((1,), dtype=dtype)
    ins5 = (X1, U1, cost.xf, cost.Q, cost.R, cost.Qf, cost.agent_mask, scalar, scalar,
            scalar, cost.n_pos, torch.zeros((K,), dtype=torch.int32), scalar, scalar)
    fl, trig, by = sol.sweep_work("backward_sweep", N, K, 4, 2, 1, n_alpha,
                                  dtype_bytes=nbytes)
    assert by == _nbytes(*ins5, K5, d5)
    # Its work: the recursion, each step's Jacobians (one sine and cosine an
    # agent) and pair terms, the terminal step's cost terms and the once-a-
    # sweep blocks.
    prep, prep_trig = sol.sweep_prep_flops(K, 4, 2)
    assert trig == N * prep_trig == N * 2 * K
    assert fl == ((sol.backward_step_flops(K, 4, 2) + prep) * N
                  + sol.sweep_prep_flops(K, 4, 2, terminal=True)[0]
                  + sol.sweep_fixed_flops(K, 4, 2))
    assert prep > sol.sweep_prep_flops(K, 4, 2, terminal=True)[0] >= sol.pair_flops(3)

    # K4: forward_pass_cuda's ``ins`` and its three outputs.
    tables1 = bt._slot_tables(
        fleet, torch.as_tensor(fleet.branch_index_array), dtype)
    outs4 = It._forward_pass(fleet.step, cost, X1, U1, K5, d5, alphas)
    ins4 = (X1, U1, K5, d5, alphas, *tables1, cost.xf, cost.Q, cost.R, cost.Qf,
            cost.agent_mask, cost.ref_weight.reshape(1), cost.radius.reshape(1),
            cost.prox_weight.reshape(1), cost.n_pos_eval)
    _, _, by = sol.sweep_work("forward_sweep", N, K, 4, 2, 1, n_alpha,
                              dtype_bytes=nbytes)
    assert by == _nbytes(*ins4, *outs4)

    # K4 without gains: rollout_cuda's inputs (the initial state, U, the
    # tables and the cost; no gains, no nominal trajectory, no alphas) and its
    # outputs X and J; its FLOPs are the line search's at one column less the
    # gain product and the control update.
    X4, J4 = It._rollout_fn(fleet.step, cost, X1[0], U1)
    fl, trig, by = sol.sweep_work("rollout_sweep", N, K, 4, 2, 1, n_alpha,
                                  dtype_bytes=nbytes)
    assert by == _nbytes(X1[0], U1, *ins4[5:], X4, J4)
    nxf, nuf = K * 4, K * 2
    assert fl == sol.sweep_work("forward_sweep", N, K, 4, 2, 1, 1,
                                dtype_bytes=nbytes)[0] - (2 * nxf * nuf + 3 * nuf) * N
    assert trig == 5 * 4 * 2 * K * N


def _patch_ceilings(monkeypatch, fma=1000.0, hbm=700.0, sin=50e9):
    monkeypatch.setattr(sol, "measure_fma_peak_gflops", lambda: fma)
    monkeypatch.setattr(sol, "measure_hbm_stream_gbps", lambda: hbm)
    monkeypatch.setattr(sol, "measure_sin_ops", lambda: sin)


@pytest.mark.parametrize("family", sol.BACKWARD_FAMILIES)
def test_kernel_sol_report_backward(monkeypatch, family):
    _patch_ceilings(monkeypatch)
    S = 1 if family == "backward_sweep" else 128
    rep = sol.kernel_sol(family, N=50, K=8, nx_p=4, nu_p=2, S=S, n_alpha=10,
                         measured_s=5e-3)
    assert rep["family"] == family
    assert rep["binding_limit"] in ("fma", "hbm")
    assert 0 < rep["sol_frac"]
    assert rep["achieved_gflop_s"] == pytest.approx(rep["gflops"] / 5e-3, rel=1e-2)
    # The bound is the larger of the compute and the memory time.
    t_trig = rep.get("trig_gops", 0.0) / 50.0
    t_c = rep["gflops"] / 1000.0 + t_trig
    t_m = rep["gbytes"] / 700.0
    assert rep["sol_s"] == pytest.approx(max(t_c, t_m), rel=1e-3)
    assert rep["sol_frac"] == pytest.approx(rep["sol_s"] / 5e-3)
    # Against the published peaks of the H100 (67 TFLOP/s, 3.35 TB/s).
    t_pub = max((rep["gflops"] + 2 * rep.get("trig_gops", 0.0)) / 67e3,
                rep["gbytes"] / 3.35e3)
    assert rep["bound_published_s"] == pytest.approx(t_pub, rel=1e-3)
    assert rep["bound_published_by"] in ("operations", "bytes")
    assert rep["published_frac"] == pytest.approx(t_pub / 5e-3, rel=1e-3)
    # All three compute their Jacobians: the sines and cosines of the
    # unicycles' are theirs.
    assert "trig_gops" in rep


def test_kernel_sol_rejects_unknown_family():
    with pytest.raises(ValueError):
        sol.kernel_sol("nope", 50, 8, 4, 2, 128, 10, 1e-3)


@pytest.mark.parametrize("family", sol.FORWARD_FAMILIES)
def test_kernel_sol_report_forward_folds_in_the_sine_rate(monkeypatch, family):
    _patch_ceilings(monkeypatch)
    S = 1 if family in ("forward_sweep", "rollout_sweep") else 128
    rep = sol.kernel_sol(family, N=50, K=8, nx_p=4, nu_p=2, S=S, n_alpha=10,
                         measured_s=5e-3, model="Unicycle4D")
    columns = 1 if family == "rollout_sweep" else 10  # the plain rollout has one
    assert rep["trig_gops"] == pytest.approx(5 * 4 * 2 * 8 * columns * 50 * S / 1e9,
                                             rel=1e-3)
    t_c = rep["gflops"] / 1000.0 + rep["trig_gops"] / 50.0
    t_m = rep["gbytes"] / 700.0
    assert rep["sol_s"] == pytest.approx(max(t_c, t_m), rel=1e-3)
    assert rep["ceiling_trig_gops_s"] == 50.0
    assert 0 < rep["trig_time_frac_of_sol"] <= 1.0
    # Twice the launches, twice the work and the bound.
    rep2 = sol.kernel_sol(family, N=50, K=8, nx_p=4, nu_p=2, S=S, n_alpha=10,
                          measured_s=5e-3, launches=2)
    assert rep2["sol_s"] == pytest.approx(2 * rep["sol_s"])


def test_published_bound_names_the_binding_limit():
    t, by = sol.published_bound(67e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = sol.published_bound(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)
    # A sine costs at least one instruction slot, two FLOPs at the peak.
    t, _ = sol.published_bound(0.0, 0.0, trig=33.5e12)
    assert t == pytest.approx(1.0)


def test_probe_work_counts():
    # (256, 512) elements: 16 FMAs = 32 FLOPs, or 16 sines, per element and
    # iteration; one read and one write of the operand.
    n = 256 * 512
    assert sol.probe_work("probe_fma", n, iters=2048) == (32 * n * 2048, 0, 8 * n)
    assert sol.probe_work("probe_sin", n, iters=256) == (0, 16 * n * 256, 8 * n)
    # 256 slabs of (512, 512): one add a value read, 256 MB read, 1 MB written.
    m = 512 * 512
    assert sol.probe_work("probe_hbm", m, T=256) == (256 * m, 0, 257 * m * 4)
    with pytest.raises(ValueError):
        sol.probe_work("probe_cos", n)
    # K8 beside its one-slot-a-sine bound: the instructions its loop issues
    # (scripts/sass_count.py), one FP32 issue slot each at half the FLOP rate.
    sines = sol.probe_work("probe_sin", n, iters=256)[1]
    one_slot = sol.published_bound(0, 0, trig=sines)[0]
    sass = sol.probe_sin_sass_bound_s(n, 256)
    assert sass == pytest.approx(one_slot * sol.SIN_LOOP_SASS / 16)
    assert 16 < sol.SIN_LOOP_SASS / 16 < 100  # tens of instructions a sinf
    assert (sol.PROBE_SHAPE, sol.FMA_ITERS, sol.SIN_ITERS, sol.HBM_MB) == (
        (256, 512), 2048, 256, 256)  # the shapes of the JAX package's probes


def test_ceilings_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        sol.sol_report()
    with pytest.raises(RuntimeError, match="CUDA"):
        sol.sol_report(device="cpu")
    x = torch.ones((4, 8))
    for wrapper in (lambda: sol.probe_fma_cuda(x, 2), lambda: sol.probe_sin_cuda(x, 2),
                    lambda: sol.probe_hbm_cuda(x)):
        with pytest.raises(ValueError, match="CUDA"):  # never the plain version
            wrapper()


# ---------------------------------------------------------------------------
# The plain probe versions against a numpy transcription of the TPU kernels'
# bodies (dpilqr_tpu/utils/sol.py:197-215, :257-268, :310-326).
# ---------------------------------------------------------------------------


def _fma_kernel_numpy(x, iters):
    f = np.float32
    a = x.astype(f)
    b = a * f(1.0000001) + f(0.0000003)
    c = a * f(0.9999999) + f(0.0000001)
    d = b * f(1.0000002) + f(0.0000002)
    for _ in range(iters):
        for _ in range(4):
            a = a * f(1.0000001) + f(1.0000001e-7)
            b = b * f(0.9999999) + f(1.0000002e-7)
            c = c * f(1.0000002) + f(0.9999998e-7)
            d = d * f(0.9999998) + f(1.0000003e-7)
    return (a + b) + (c + d)


def _sin_kernel_numpy(x, iters):
    f = np.float32
    a = x.astype(f)
    b, c, d = a * f(0.99), a * f(1.01), a * f(0.98)
    for _ in range(iters):
        for _ in range(4):
            a, b, c, d = np.sin(a), np.sin(b), np.sin(c), np.sin(d)
    return (a + b) + (c + d)


def _hbm_kernel_numpy(x):
    acc = np.zeros(x.shape[1:], np.float32)
    for t in range(x.shape[0]):  # the sequential grid over the leading axis
        acc = acc + x[t]
    return acc


def test_plain_probes_match_the_tpu_kernel_bodies():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 1.5, (8, 16)).astype(np.float32)
    xt = torch.as_tensor(x)
    got = sol.probe_fma_torch(xt, 8).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _fma_kernel_numpy(x, 8), rtol=1e-6)
    got = sol.probe_sin_torch(xt, 3).numpy()
    np.testing.assert_allclose(got, _sin_kernel_numpy(x, 3), rtol=1e-6)
    x3 = rng.normal(size=(7, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(sol.probe_hbm_torch(torch.as_tensor(x3)).numpy(),
                               _hbm_kernel_numpy(x3), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# On a card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_probes_match_their_plain_versions(cuda_device):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(0.5, 1.5, (64, 96)).astype(np.float32),
                        device=cuda_device)
    # A fused multiply-add rounds once where the plain version rounds twice:
    # over 8 x 4 steps of four chains the results stay within 1e-5 relative.
    got, want = sol.probe_fma_cuda(x, 8), sol.probe_fma_torch(x, 8)
    assert float(((got - want) / want).abs().max()) <= 1e-5
    # sinf against torch.sin: a few ulp per step, contracting chains.
    got, want = sol.probe_sin_cuda(x, 3), sol.probe_sin_torch(x, 3)
    assert float(((got - want) / want).abs().max()) <= 1e-5
    # 37 slabs: an unrolled part and a remainder; float32 sums in another order.
    x3 = torch.as_tensor(rng.normal(size=(37, 24, 40)).astype(np.float32),
                         device=cuda_device)
    got, want = sol.probe_hbm_cuda(x3), sol.probe_hbm_torch(x3)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4
    with pytest.raises(ValueError):
        sol.probe_hbm_cuda(x3[:, :3, :39].contiguous())  # 117 values a slab, not 4k
    # The shapes the ceilings are measured at: 256 sine iterations (the chains
    # contract, so a few ulp a step stay within 1e-5 relative), and a 256 MB
    # buffer (sums of 256 normals in another order, 1e-4 absolute).
    xs = torch.as_tensor(rng.uniform(0.5, 1.5, sol.PROBE_SHAPE).astype(np.float32),
                         device=cuda_device)
    got, want = sol.probe_sin_cuda(xs, sol.SIN_ITERS), sol.probe_sin_torch(xs, sol.SIN_ITERS)
    assert float(((got - want) / want).abs().max()) <= 1e-5
    x3 = torch.as_tensor(rng.standard_normal((256, 512, 512), dtype=np.float32),
                         device=cuda_device)
    got, want = sol.probe_hbm_cuda(x3), sol.probe_hbm_torch(x3)
    assert float((got - want).abs().max()) <= 1e-4
    with pytest.raises(ValueError):
        sol.probe_fma_cuda(x.double(), 2)


@pytest.mark.cuda
def test_cuda_sol_report_shares_are_plausible(cuda_device):
    rep = sol.sol_report(cuda_device, k=5)
    ceil = rep["ceilings"]
    assert 0 < ceil["fma_gflop_s"] <= 1.05 * 67e3
    assert 0 < ceil["hbm_gb_s"] <= 1.05 * 3.35e3
    # A sine is many instructions: its rate stays below the FMA instruction rate.
    assert 0 < ceil["sin_gops_s"] < ceil["fma_gflop_s"] / 2
    assert set(rep["kernels"]) == {"K1", "K2", "K3", "K4", "K4 rollout", "K5"}
    for tag, r in rep["kernels"].items():
        assert r["outputs_finite"], tag
        assert 0 < r["sol_frac"] <= 1.05, (tag, r)
        assert 0 < r["published_frac"] <= 1.05, (tag, r)
    # Float32 over N = 200: the scan and the sequential sweep round differently.
    assert rep["pscan"]["max_rel_err_vs_sequential"] < 5e-2
