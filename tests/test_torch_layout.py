"""Memory layouts and shared-memory budgets of the port's batched sweeps.

The kernels keep a subproblem's step contiguous in memory (gains as ``(S,
N, nuf, nxf)``, line-search candidates column-major as ``(n_alpha, S, N, K,
nx_p)``) and hand the tensors out as permuted views in the JAX package's
shapes.  On the CPU the twins produce the same views, so these tests hold
the shapes, the values behind either layout, ``select_alpha`` against the
gather it replaces, the per-fleet slot tables, and the kernels'
shared-memory plans (``csrc/plan.h``, read through ``cuda_build.riccati_plan``
and ``forward_plan`` from its host build).

The ``cuda`` cases hold the card's opt-in limit to the one the plans are
made under and the kernels against their twins at the compacted batch
widths, on a card; they skip without one.
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops import cuda_build
from dpilqr_tpu_torch.ops.cuda_build import (SMEM_LIMIT, cluster_max, forward_plan,
                                              riccati_plan)
from dpilqr_tpu_torch.ops.costs import game_cost_from_numpy
from dpilqr_tpu_torch.ops.ilqr import line_search_alphas

torch.set_num_threads(1)

HETERO = ["DoubleInt4D", "Car3D", "Bike5D"]
# (K, nx_p, nu_p) of every subproblem shape chip_smoke.py drives and the
# routing admits: the main path (K = 1 and 8), the routing datum (K = 2, 4,
# 6), quadrotor swarms up to the quad6d_64 loop's auto K = 32 (nxf 192, nuf
# 96), the mixed fleet at K = 8, Car3D at a wide nuf.
SHAPES = [(1, 4, 2), (2, 4, 2), (4, 4, 2), (6, 4, 2), (8, 4, 2), (8, 6, 3),
          (16, 6, 3), (4, 12, 4), (8, 12, 4), (8, 5, 2), (32, 3, 2), (24, 4, 2),
          (32, 6, 3)]


def _batch(names, S, K, N=4, seed=0, spread=0.3, rates=0.3):
    """Seeded batch over the models ``names`` with one padded slot: fleet,
    cost fields, branch indices, X, U, mu (numpy, float64).  States are
    normal, the first two (positions) with deviation ``spread`` (at 0.3 most
    slots lie inside each other's radius, 0.5), the rest (a third position,
    headings, angles, rates) with deviation ``rates``."""
    rng = np.random.default_rng(seed)
    fleet = dtt.Fleet.from_names(names, 0.1)
    nx_p, nu_p = fleet.nx_p, fleet.nu_p
    mids = rng.integers(0, len(names), (S, K)).astype(np.int32)
    mask = np.ones((S, K))
    mask[S // 2, K - 1] = 0.0  # one padded slot
    smask = np.stack([[fleet.state_mask[m] for m in row] for row in mids])
    umask = np.stack([[fleet.control_mask[m] for m in row] for row in mids])
    X = rates * rng.standard_normal((S, N + 1, K, nx_p)) * smask[:, None]
    X[..., :2] *= spread / rates
    U = 0.3 * rng.standard_normal((S, N, K, nu_p)) * umask[:, None]
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


def _tensors(fields, mids, X, U, mu, dtype=torch.float64, device="cpu"):
    cost = game_cost_from_numpy(fields, device, dtype)
    return (cost, torch.as_tensor(mids, device=device),
            *(torch.as_tensor(a, dtype=dtype, device=device) for a in (X, U, mu)))


def _rounded_inputs_gains(fleet, fields, mids_t, Xt, Ut, mut):
    """The plain version's gains with its inputs computed in float64 and
    rounded to the batch's type once: a second sample, beside the twin's own
    prep, of the rounding the type alone leaves in the gains (K1 and K3
    round their inputs in their own order)."""
    dev = Xt.device
    cost = game_cost_from_numpy(fields, dev, torch.float64)
    X, U = Xt.double(), Ut.double()
    q = bt._quadraticize_batch(cost, X, U)
    A, B = bt._linearize_batch(fleet, cost, mids_t, X, U)
    return bt.backward_pass_batched_torch(*(a.to(Xt.dtype) for a in (
        A, B, q["L_uu"], q["L_xx"], q["L_x"], q["L_u"], mut, q["p0"], q["P0"])))


def _rounding(refs, *samples):
    """Per output, the largest distance of the samples from the float64 refs."""
    return [max(float((s.double() - r).abs().max()) for s in outs)
            for r, *outs in zip(refs, *samples)]


@pytest.fixture(scope="module")
def sweep():
    """A mixed batch's gains and candidates from the twins."""
    S, K, n_alpha = 5, 4, 3
    fleet, fields, mids, X, U, mu = _batch(["Unicycle4D", "Bike5D"], S, K)
    cost, mids_t, Xt, Ut, mut = _tensors(fields, mids, X, U, mu)
    Kg, d = bt.backward_pass_batched(fleet, cost, mids_t, Xt, Ut, mut)
    alphas = line_search_alphas(n_alpha, torch.float64)
    X5, U5, J = bt.forward_pass_batched(fleet, cost, mids_t, Xt, Ut, 0.1 * Kg, 0.1 * d,
                                        alphas)
    return dict(fleet=fleet, cost=cost, mids=mids_t, X=Xt, U=Ut, Kg=Kg, d=d,
                alphas=alphas, X5=X5, U5=U5, J=J, S=S, K=K, N=Ut.shape[1])


def test_public_shapes_over_step_contiguous_memory(sweep):
    S, K, N = sweep["S"], sweep["K"], sweep["N"]
    nx_p, nu_p = sweep["fleet"].nx_p, sweep["fleet"].nu_p
    nxf, nuf, n_alpha = K * nx_p, K * nu_p, sweep["alphas"].shape[0]
    assert sweep["Kg"].shape == (N, nuf, nxf, S)
    assert sweep["d"].shape == (N, nuf, S)
    assert sweep["X5"].shape == (N, nx_p, K, n_alpha, S)
    assert sweep["U5"].shape == (N, nu_p, K, n_alpha, S)
    assert sweep["J"].shape == (n_alpha, S)
    # One subproblem's step is one contiguous block; one candidate one row.
    assert sweep["Kg"].permute(bt.GAIN_ORDER).is_contiguous()
    assert sweep["d"].permute(bt.D_ORDER).is_contiguous()
    assert sweep["X5"].permute(bt.COLUMN_ORDER).is_contiguous()
    assert sweep["U5"].permute(bt.COLUMN_ORDER).is_contiguous()
    assert sweep["Kg"].permute(bt.GAIN_ORDER).shape == (S, N, nuf, nxf)
    assert sweep["X5"].permute(bt.COLUMN_ORDER).shape == (n_alpha, S, N, K, nx_p)


def test_as_layout_keeps_values_and_copies_only_when_needed(sweep):
    Kg = sweep["Kg"]
    assert bt.as_layout(Kg, bt.GAIN_ORDER).data_ptr() == Kg.data_ptr()
    plain = Kg.contiguous()  # the JAX package's memory order
    assert not plain.permute(bt.GAIN_ORDER).is_contiguous()
    back = bt.as_layout(plain, bt.GAIN_ORDER)
    assert back.shape == plain.shape and torch.equal(back, plain)
    assert back.permute(bt.GAIN_ORDER).is_contiguous()
    assert back.data_ptr() != plain.data_ptr()


def test_forward_takes_gains_in_either_memory_order(sweep):
    args = (sweep["fleet"], sweep["cost"], sweep["mids"], sweep["X"], sweep["U"])
    want = (sweep["X5"], sweep["U5"], sweep["J"])
    got = bt.forward_pass_batched(*args, (0.1 * sweep["Kg"]).contiguous(),
                                  (0.1 * sweep["d"]).contiguous(), sweep["alphas"])
    # The gain product's sums run in another order over other strides.
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-13 * float(w.abs().max())


def _select_alpha_by_gather(X5, U5, x0_s, a_idx):
    """The gather ``select_alpha`` replaces (over the public shapes)."""
    N, nx_p, K, _, S = X5.shape
    nu_p = U5.shape[1]
    ix = a_idx.long().view(1, 1, 1, 1, S)
    Xsel = X5.gather(3, ix.expand(N, nx_p, K, 1, S))[:, :, :, 0]
    Usel = U5.gather(3, ix.expand(N, nu_p, K, 1, S))[:, :, :, 0]
    X = torch.cat([x0_s[:, None], Xsel.permute(3, 0, 2, 1)], dim=1)
    return X, Usel.permute(3, 0, 2, 1).contiguous()


@pytest.mark.parametrize("memory", ["column-major", "jax"])
def test_select_alpha_equals_the_gather(sweep, memory):
    X5, U5 = sweep["X5"], sweep["U5"]
    if memory == "jax":
        X5, U5 = X5.contiguous(), U5.contiguous()
    x0_s = sweep["X"][:, 0]
    a_idx = torch.tensor([2, 0, 1, 1, 2], dtype=torch.int32)
    Xn, Un = bt.select_alpha(X5, U5, x0_s, a_idx)
    Xw, Uw = _select_alpha_by_gather(X5, U5, x0_s, a_idx)
    assert Xn.shape == sweep["X"].shape and Un.shape == sweep["U"].shape
    assert torch.equal(Xn, Xw) and torch.equal(Un, Uw)
    assert Xn.is_contiguous() and Un.is_contiguous()


def test_cat_alphas_joins_candidate_sets(sweep):
    X5 = sweep["X5"]
    joined = bt._cat_alphas(X5[:, :, :, :1], X5[:, :, :, 1:])
    assert torch.equal(joined, X5)
    assert joined.permute(bt.COLUMN_ORDER).is_contiguous()


def test_check_tensors_holds_the_memory_order(sweep):
    Kg = sweep["Kg"]
    shapes = {"Kg": tuple(Kg.shape)}
    ok = dict(tensors={"Kg": Kg}, shapes=shapes, dtype=Kg.dtype, device=Kg.device,
              layouts={"Kg": bt.GAIN_ORDER})
    cuda_build.check_tensors("forward_batched", **ok)
    with pytest.raises(ValueError, match="memory order"):
        cuda_build.check_tensors("forward_batched", **{**ok, "tensors": {"Kg": Kg.contiguous()}})
    with pytest.raises(ValueError, match="contiguous"):
        cuda_build.check_tensors("forward_batched", {"Kg": Kg}, shapes, Kg.dtype, Kg.device)


@pytest.mark.parametrize("names", [["Unicycle4D"], HETERO], ids=["homogeneous", "mixed"])
def test_slot_tables_are_built_once_per_fleet(names):
    fleet = dtt.Fleet.from_names(names * 2, 0.1)
    mids = torch.as_tensor(np.random.default_rng(0).integers(0, len(names), (3, 4)),
                           dtype=torch.int32)
    first = bt._model_tables(fleet.unique_specs, fleet.dt, torch.float64, mids.device)
    again = bt._model_tables(fleet.unique_specs, fleet.dt, torch.float64, mids.device)
    assert all(a is b for a, b in zip(first, again))
    model, nsub, dh = bt._slot_tables(fleet, mids, torch.float64)
    specs = fleet.unique_specs
    for s in range(3):
        for k in range(4):
            spec = specs[int(mids[s, k])]
            assert int(model[s, k]) == spec.model_id
            assert int(nsub[s, k]) == spec.rk4_substeps
            assert float(dh[s, k]) == 0.1 / spec.rk4_substeps
    assert model.dtype == nsub.dtype == torch.int32 and model.is_contiguous()
    assert bt._slot_tables(fleet, mids, torch.float32)[2].dtype == torch.float32


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "K{}nx{}nu{}".format(*s))
def test_every_routed_shape_fits_shared_memory(shape, itemsize):
    K, nx, nu = shape
    # The backward kernels' plan: what it moves out of shared memory lies in
    # the workspace, so the two together are the working set that an
    # unbounded block holds whole (tier 0).
    tier, smem, work, cluster = riccati_plan(K, nx, nu, itemsize)
    whole = riccati_plan(K, nx, nu, itemsize, limit=1 << 40)
    assert cluster == 1 and whole.tier == 0 and whole.work == 0
    assert tier in (0, 1, 2) and 0 < smem <= SMEM_LIMIT
    assert smem // itemsize + work == whole.smem // itemsize
    assert (work == 0) == (tier == 0)
    if K * nx <= bt.MAX_NXF:  # the narrow kernel keeps everything in shared memory
        assert tier == 0
    for n_alpha in (1, 2, 10):
        for gains in (True, False):
            plan = forward_plan(K, nx, nu, n_alpha, itemsize, gains)
            # A step's whole gain block a buffer (no tiles at a routed
            # width); only nxf 192 in float64 is down to one such stage.
            one = gains and (K * nx, itemsize) == (192, 8)
            assert plan.rows == (K * nu if gains else 0)
            assert plan.buffers == (1 if one or not gains else 2)
            assert plan.chunks * plan.warps >= n_alpha and plan.warps <= 8
            assert 0 < plan.nbytes <= SMEM_LIMIT


def test_working_set_placement_follows_type_and_width():
    # Quad6D at K=16 (nxf 96, nuf 48) with the backward kernels' input
    # buffers (per-slot blocks, a step's pair blocks) in the gain group: the
    # matrices in the workspace in float32, the gains too in float64;
    # Quad12D at K=8 in float64 keeps its gain blocks in shared memory, and
    # nothing narrow leaves tier 0.
    assert riccati_plan(16, 6, 3, 4).tier == 1
    assert riccati_plan(16, 6, 3, 8).tier == 2
    assert riccati_plan(8, 12, 4, 8).tier == 1
    assert riccati_plan(8, 4, 2, 8).tier == 0
    # Twice the widest routed width (nxf 192, nuf 96) is answered, not
    # refused: matrices and gains move to the workspace, only the vectors
    # stay; the forward kernel keeps two stages in float32 and one in
    # float64.
    tier, smem, work, _ = riccati_plan(32, 6, 3, 4)
    assert tier == 2 and smem <= SMEM_LIMIT and smem < work
    assert smem + 4 * work == riccati_plan(32, 6, 3, 4, limit=1 << 40).smem
    assert forward_plan(32, 6, 3, 10, 4).buffers == 2
    assert forward_plan(32, 6, 3, 10, 8).buffers == 1
    # Twice that again, the forward kernel takes the gain block in tiles of
    # rows; the only limit is the memory itself.
    assert forward_plan(64, 6, 3, 10, 8).placement(192) == "tiles"
    with pytest.raises(ValueError, match="shared memory"):
        forward_plan(4000, 6, 3, 10, 8)
    with pytest.raises(ValueError, match="shared memory"):
        riccati_plan(4000, 6, 3, 8)
    plan = forward_plan(64, 6, 3, 10, 8, limit=8 * SMEM_LIMIT)
    assert plan.buffers == 2 and plan.placement(192) == "stages"


# ---------------------------------------------------------------------------
# On a card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_opt_in_is_the_plans_limit(cuda_device):
    # The kernels plan each launch under the card's opt-in, the wrappers
    # under SMEM_LIMIT: one limit, so that both make the same plan.
    props = torch.cuda.get_device_properties(cuda_device)
    assert props.shared_memory_per_block_optin == SMEM_LIMIT


# The widths the retirement schedule compacts a batch to, a mixed fleet with
# per-slot substeps (nxf 40: the wide backward kernel) and unicycles at K=4
# (nxf 16: the narrow one), each batch with a padded slot.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("S", [16, 32, 48])
@pytest.mark.parametrize("names,K", [(HETERO, 8), (["Unicycle4D"], 4), (["Quad6D"], 8)],
                         ids=["mixed-nxf40", "unicycle-nxf16", "quad6d-nxf48"])
def test_cuda_kernels_match_twins_at_compacted_widths(cuda_device, names, K, S, dtype):
    tol = {torch.float64: (1e-9, 1e-9), torch.float32: (2e-3, 1e-4)}[dtype]
    fleet, fields, mids, X, U, mu = _batch(names, S, K, N=6, seed=7)
    cost, mids_t, Xt, Ut, mut = _tensors(fields, mids, X, U, mu, dtype, cuda_device)
    assert float(cost.agent_mask.min()) == 0.0
    Kg_t, d_t = bt.backward_pass_batched(fleet, cost, mids_t, Xt, Ut, mut, "torch")
    Kg_c, d_c = bt.backward_pass_batched(fleet, cost, mids_t, Xt, Ut, mut, "cuda")
    assert Kg_c.shape == Kg_t.shape and Kg_c.permute(bt.GAIN_ORDER).is_contiguous()
    # These random batches pack their slots inside the radius, so Q_uu is
    # ill conditioned and float32 rounding alone moves the gains by more
    # than 2e-3 in some of the 48 subproblems: there the kernel is held to
    # the float32 plain versions' own distance from the float64 one.  The
    # kernel computes its inputs itself, rounding its own float32 products,
    # so its distance is taken from the float64 plain version, and the
    # rounding is that of the twin and of the float64 inputs rounded once.
    Kg_64, d_64 = bt.backward_pass_batched(
        fleet, game_cost_from_numpy(fields, cuda_device, torch.float64), mids_t,
        Xt.double(), Ut.double(), mut.double(), "torch")
    rounding = _rounding((Kg_64, d_64), (Kg_t, d_t),
                         _rounded_inputs_gains(fleet, fields, mids_t, Xt, Ut, mut))
    for a, ref, rnd in zip((Kg_c, d_c), (Kg_64, d_64), rounding):
        assert float((a.double() - ref).abs().max()) <= max(
            tol[0] * float(ref.abs().max()), 4.0 * rnd)
    # Gains scaled to max|Kg| = 0.1, so that the closed loop of these random
    # batches stays well conditioned (see tests/test_torch_wide.py).
    s = 0.1 / float(Kg_t.abs().max())
    for n_alpha in (1, 2, 10):
        alphas = line_search_alphas(n_alpha, dtype, cuda_device)
        args = (fleet, cost, mids_t, Xt, Ut, s * Kg_t, s * d_t, alphas)
        got = bt.forward_pass_batched(*args, backend="cuda")
        want = bt.forward_pass_batched(*args, backend="torch")
        assert got[0].permute(bt.COLUMN_ORDER).is_contiguous()
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= tol[1] * float(b.abs().max())
        a_idx = torch.argmin(got[2], dim=0).to(torch.int32)
        for a, b in zip(bt.select_alpha(got[0], got[1], Xt[:, 0], a_idx),
                        bt.select_alpha(want[0], want[1], Xt[:, 0], a_idx)):
            assert float((a - b).abs().max()) <= tol[1] * float(b.abs().max())


# The narrow kernel at flat widths that are no multiple of 4 (Car3D, Bike5D,
# Quad6D slots), at K = 1, and at the batch widths a solve runs; mu spread
# from 0.25 to 4.  Its elimination runs in one warp's registers, instantiated
# for nuf <= 8, 16 and 32; Unicycle4D slots also compile nx, nu (and K = 8) in.
NARROW = {
    "car3d-nxf3": (["Car3D"], 1), "unicycle-nxf4": (["Unicycle4D"], 1),
    "car3d-nxf15": (["Car3D"], 5), "unicycle-nxf24": (["Unicycle4D"], 6),
    "quad12d-nxf24": (["Quad12D"], 2), "bike5d-nxf30": (["Bike5D"], 6),
    "car3d-nxf30-nuf20": (["Car3D"], 10), "quad6d-nxf30": (["Quad6D"], 5),
    "unicycle-nxf32": (["Unicycle4D"], 8), "mixed-nxf20": (HETERO, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("S", [1, 16, 100, 128])
@pytest.mark.parametrize("case", sorted(NARROW))
def test_cuda_narrow_kernel_matches_twin(cuda_device, case, S, dtype):
    names, K = NARROW[case]
    # Slots a metre apart (some pairs inside the radius) at small angles and
    # rates: gains that float32 resolves.  Packed at 0.3, or with steering
    # angles and body rates of 0.3, these batches have gains of 1e4 to 1e7.
    fleet, fields, mids, X, U, _ = _batch(names, S, K, N=6, seed=11, spread=1.0,
                                          rates=0.1)
    mu = np.geomspace(0.25, 4.0, S)
    cost, mids_t, Xt, Ut, mut = _tensors(fields, mids, X, U, mu, dtype, cuda_device)
    assert K * fleet.nx_p <= bt.MAX_NXF
    args = (fleet, cost, mids_t, Xt, Ut, mut)
    got = bt.backward_pass_batched_cuda(*args)
    want = bt.backward_pass_batched(*args, "torch")
    wide = bt.backward_pass_batched_wide_cuda(*args)
    ref = bt.backward_pass_batched(
        fleet, game_cost_from_numpy(fields, cuda_device, torch.float64), mids_t,
        Xt.double(), Ut.double(), mut.double(), "torch")
    rounding = _rounding(ref, want,
                         _rounded_inputs_gains(fleet, fields, mids_t, Xt, Ut, mut))
    for a, b, w, r, rnd in zip(got, want, wide, ref, rounding):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        # The two kernels share every entry's arithmetic: the same bits.
        assert torch.equal(a, w)
        # Float32: these packed random batches are ill conditioned (rounding
        # alone moves the twin's gains by far more than 2e-3 in some
        # subproblems), so there the kernel is held to a multiple of the
        # float32 plain versions' own distance from the float64 one; the
        # kernel rounds its own float32 inputs, so its distance is taken from
        # the float64 plain version too.
        tol = 1e-9 if dtype == torch.float64 else 2e-3
        assert float((a.double() - r).abs().max()) <= max(tol * float(r.abs().max()),
                                                          16.0 * rnd)


# Past nxf 96: Quad6D at K = 32 (nxf 192, nuf 96), where the wide backward
# kernel puts a subproblem on a cluster of eight CTAs in float32 (every
# launch counted under the cluster tier) and keeps every matrix in its
# workspace, eliminating in place, in float64; the forward kernel stages
# two gain blocks in float32 and one in float64.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_kernels_match_twins_at_nxf_192(cuda_device, dtype):
    tol = {torch.float64: (1e-9, 1e-9), torch.float32: (2e-3, 1e-4)}[dtype]
    fleet, fields, mids, X, U, mu = _batch(["Quad6D"], 6, 32, N=5, seed=13)
    cost, mids_t, Xt, Ut, mut = _tensors(fields, mids, X, U, mu, dtype, cuda_device)
    item = Xt.element_size()
    assert riccati_plan(32, 6, 3, item).tier == 2
    tier = riccati_plan(32, 6, 3, item, cluster_max()).tier
    assert tier == (3 if dtype == torch.float32 else 2)
    Kg_t, d_t = bt.backward_pass_batched(fleet, cost, mids_t, Xt, Ut, mut, "torch")
    before = cuda_build.tier_counts.get(("backward_batched_wide", tier), 0)
    Kg_c, d_c = bt.backward_pass_batched(fleet, cost, mids_t, Xt, Ut, mut, "cuda")
    assert cuda_build.tier_counts[("backward_batched_wide", tier)] == before + 1
    Kg_64, d_64 = bt.backward_pass_batched(
        fleet, game_cost_from_numpy(fields, cuda_device, torch.float64), mids_t,
        Xt.double(), Ut.double(), mut.double(), "torch")
    assert float(Kg_t.abs().max()) > 0 and not torch.equal(Kg_c, torch.zeros_like(Kg_c))
    rounding = _rounding((Kg_64, d_64), (Kg_t, d_t),
                         _rounded_inputs_gains(fleet, fields, mids_t, Xt, Ut, mut))
    for a, ref, rnd in zip((Kg_c, d_c), (Kg_64, d_64), rounding):
        assert float((a.double() - ref).abs().max()) <= max(
            tol[0] * float(ref.abs().max()), 4.0 * rnd)
    s = 0.1 / float(Kg_t.abs().max())
    for n_alpha in (2, 10):
        alphas = line_search_alphas(n_alpha, dtype, cuda_device)
        args = (fleet, cost, mids_t, Xt, Ut, s * Kg_t, s * d_t, alphas)
        for a, b in zip(bt.forward_pass_batched(*args, backend="cuda"),
                        bt.forward_pass_batched(*args, backend="torch")):
            assert float((a - b).abs().max()) <= tol[1] * float(b.abs().max())
