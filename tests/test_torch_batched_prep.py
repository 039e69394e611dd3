"""The inputs K1 and K3 compute for themselves (csrc/computed_inputs.cuh),
compiled for the host and held against both torch preps, float64.

The backward kernels of the decomposed solve compute each step's
Euler-discretized Jacobians, cost gradients and Hessian blocks inside the
kernel, subproblem by subproblem, through ``slot_problem`` (a subproblem's
view of the batch: its rows of the trajectory, its per-slot cost, its slots'
branch indices mapped to model ids) and the work items of
``sweep_prep_items_inline``.  g++ builds ``csrc/derivatives_host.cpp``
(``cuda_build.host_build``), whose ``dpilqr_host_batched_prep`` runs those
functions on one thread and assembles the dense Hessians from their blocks
as the kernels read them.  On subproblems gathered from real decompositions
(``parallel.subproblems``: an interaction graph of a rolled-out trajectory,
slots owner first, padded slots holding the owner's state under mask 0) its
A, B, L_x, L_u, L_xx, L_uu and the terminal step's p0 and P0 must match the
port's ``_quadraticize_batch`` / ``_linearize_batch`` and the JAX package's
(``dpilqr_tpu.ops.pallas_batched``, its flat-lanes layout transposed back)
to 1e-12 relative to max(|.|, 1): Unicycle4D at K=8, a mixed DoubleInt4D +
Car3D + Bike5D fleet at K=4 with padded slots, Quad6D at K=16 and Quad12D at
K=1.
"""

import ctypes

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops.codegen import library_ids
from dpilqr_tpu_torch.ops.cuda_build import CSRC_DIR, host_build
from dpilqr_tpu_torch.parallel.graph import interaction_graph
from dpilqr_tpu_torch.parallel.subproblems import (gather_controls, gather_cost,
                                                   gather_subproblems)

torch.set_num_threads(1)

RTOL = 1e-12
DT, N = 0.1, 6
_SRC = CSRC_DIR / "derivatives_host.cpp"
_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off")
G = 9.80665


@pytest.fixture(scope="module")
def lib():
    L = ctypes.CDLL(str(host_build(_SRC, _FLAGS, "libderivatives.so")))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    L.dpilqr_host_batched_prep.argtypes = [I] * 5 + [P] * 13 + [D] + [P] * 8
    L.dpilqr_host_batched_prep.restype = I
    L.dpilqr_host_batched_prep_rows.argtypes = [I] * 5 + [P] * 13 + [D] + [P] * 8 + [I]
    L.dpilqr_host_batched_prep_rows.restype = I
    return L


# name: (models of the fleet in order, slots K, start spacing, graph radius,
# control trim per model name, control noise, position coordinates).
CASES = {
    "unicycle-k8": (["Unicycle4D"] * 16, 8, 0.4, 0.6, {}, 0.05, 2),
    "mixed-k4-padded": (["DoubleInt4D", "Car3D", "Bike5D"] * 3, 4, 0.55, 0.35, {},
                        0.05, 2),
    "quad6d-k16": (["Quad6D"] * 20, 16, 0.5, 0.6, {"Quad6D": [G, 0.0, 0.0]}, 0.05, 3),
    # Quad12D's torque gains are ~6e4: a torque noise of 1e-7 already turns
    # it within the horizon.
    "quad12d-k1": (["Quad12D"] * 4, 1, 0.5, 0.5,
                   {"Quad12D": [0.0, 0.0, 0.0, G * 63 / 2000]}, 1e-7, 3),
}


def _decomposition(case, seed=0):
    """The fleet, its subproblem batch and the gathered trajectory of one
    case: starts on a jittered grid, the rollout of small random controls
    about each model's trim (in float64 on the CPU), the interaction graph
    of that trajectory, then the batch of every agent's neighbourhood."""
    names, K, spacing, graph_radius, trims, noise, n_pos = CASES[case]
    rng = np.random.default_rng(seed)
    fleet = dtt.Fleet.from_names(names, DT)
    n, nx, nu = fleet.n_agents, fleet.nx_p, fleet.nu_p
    side = int(np.ceil(n ** (1 / n_pos)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * n_pos, indexing="ij"), -1)
    x0 = np.zeros((n, nx))
    x0[:, :n_pos] = grid.reshape(-1, n_pos)[:n] * spacing + rng.uniform(
        -0.05, 0.05, (n, n_pos))
    x0 *= fleet.state_mask
    trim = np.stack([np.pad(trims.get(s.name, np.zeros(s.n_u)), (0, nu - s.n_u))
                     for s in fleet.specs])
    U = (trim + noise * rng.standard_normal((N, n, nu))) * fleet.control_mask
    Q = rng.uniform(0.2, 1.0, (n, nx, nx)) * fleet.state_mask[:, :, None]
    R = rng.uniform(0.2, 1.0, (n, nu, nu))
    xf = rng.normal(size=(n, nx)) * fleet.state_mask
    cost = dtt.make_game_cost(
        xf, Q, R, 10.0 * Q, radius=0.6, n_pos=np.array(fleet.n_pos, np.int32),
        prox_weight=150.0, ref_weight=1.3, dtype=torch.float64, device="cpu")
    Ut = torch.as_tensor(U)
    X, _ = dtt.rollout(fleet, cost, torch.as_tensor(x0), Ut)
    batch = gather_subproblems(
        interaction_graph(X, graph_radius, n_pos=cost.n_pos), K)
    sub_cost = gather_cost(cost, batch, torch.float64)
    Xs = X[:, batch.member_idx].transpose(0, 1).contiguous()
    Us = gather_controls(Ut, batch)
    branch = torch.as_tensor(fleet.branch_index_array, dtype=torch.int32)
    return names, fleet, batch, sub_cost, branch[batch.member_idx], Xs, Us


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _host_prep(lib, fleet, sub_cost, mids, Xs, Us, ranks=0):
    """``dpilqr_host_batched_prep`` on the batch, in the port's layout; with
    ``ranks`` > 0 ``dpilqr_host_batched_prep_rows``, the inputs as that many
    ranks of K3's cluster tier compute them, each its own agents' rows."""
    S, Np1, K, nx = Xs.shape
    nu = Us.shape[-1]
    nxf, nuf = K * nx, K * nu
    f = {k: np.ascontiguousarray(getattr(sub_cost, k).numpy())
         for k in sub_cost._fields}
    ids = np.array(library_ids(fleet.unique_specs), np.int32)
    out = dict(A=np.zeros((S, N, K, nx, nx)), B=np.zeros((S, N, K, nx, nu)),
               L_x=np.zeros((S, N, nxf)), L_u=np.zeros((S, N, nuf)),
               L_xx=np.zeros((S, N, nxf, nxf)), L_uu=np.zeros((S, N, nuf, nuf)),
               p0=np.zeros((S, nxf)), P0=np.zeros((S, nxf, nxf)))
    X, U = np.ascontiguousarray(Xs.numpy()), np.ascontiguousarray(Us.numpy())
    m = np.ascontiguousarray(mids.numpy())
    args = (S, N, K, nx, nu, _p(X), _p(U), _p(f["xf"]), _p(f["Q"]), _p(f["R"]),
            _p(f["Qf"]), _p(f["agent_mask"]), _p(f["ref_weight"]), _p(f["radius"]),
            _p(f["prox_weight"]), _p(f["n_pos"]), _p(m), _p(ids), DT,
            *(_p(out[k]) for k in ("A", "B", "L_x", "L_u", "L_xx", "L_uu", "p0", "P0")))
    if ranks:
        assert lib.dpilqr_host_batched_prep_rows(*args, ranks) == 0
    else:
        assert lib.dpilqr_host_batched_prep(*args) == 0
    return out


# K3's cluster tier: each rank computes its own agents' inputs
# (sweep_prep_rows_inline) and its own rows of L_xx; the ranks together give
# the whole prep's bits, at every split of the slots (even and uneven).
@pytest.mark.parametrize("case,ranks", [("quad6d-k16", 2), ("quad6d-k16", 3),
                                        ("quad6d-k16", 8), ("unicycle-k8", 3),
                                        ("unicycle-k8", 8), ("mixed-k4-padded", 4)])
def test_host_prep_by_ranks_matches_the_whole_prep(lib, case, ranks):
    _, fleet, _, sub_cost, mids, Xs, Us = _decomposition(case)
    whole = _host_prep(lib, fleet, sub_cost, mids, Xs, Us)
    split = _host_prep(lib, fleet, sub_cost, mids, Xs, Us, ranks=ranks)
    for key, want in whole.items():
        assert np.array_equal(split[key], want), key


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_prep_matches_the_port_and_the_jax_prep(lib, case):
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.ops import pallas_batched as pj
    from dpilqr_tpu.ops.costs import GameCost as JaxGameCost

    names, fleet, batch, sub_cost, mids, Xs, Us = _decomposition(case)
    S, _, K, nx = Xs.shape
    nu = Us.shape[-1]
    nxf, nuf = K * nx, K * nu
    # Preconditions: a finite trajectory; pairs inside the cost's radius
    # couple the slots; the mixed batch has padded slots.
    assert bool(torch.isfinite(Xs).all())
    if K > 1:
        assert float(bt._quadraticize_batch(sub_cost, Xs, Us)["L_xx"][
            :, :, :nx, nx:].abs().max()) > 0
    if case == "mixed-k4-padded":
        assert float(sub_cost.agent_mask.min()) == 0.0
        assert len(fleet.unique_specs) == 3
    got = _host_prep(lib, fleet, sub_cost, mids, Xs, Us)

    # The port's torch prep.
    q = bt._quadraticize_batch(sub_cost, Xs, Us)
    A, B = bt._linearize_batch(fleet, sub_cost, mids, Xs, Us)
    for key, want in dict(q, A=A, B=B).items():
        _close(got[key], want.numpy())

    # The JAX package's, from the same numpy arrays.
    cost_j = JaxGameCost(**{k: jnp.asarray(getattr(sub_cost, k).numpy())
                            for k in sub_cost._fields})
    Xj, Uj = jnp.asarray(Xs.numpy()), jnp.asarray(Us.numpy())
    qj = pj._quadraticize_batch(cost_j, Xj, Uj)
    Aj, Bj = pj._linearize_batch(dtl.Fleet(tuple(names), DT), cost_j,
                                 jnp.asarray(mids.numpy()), Xj, Uj)
    jax_port_layout = dict(
        L_x=np.asarray(qj["L_x"]).transpose(2, 0, 1),
        L_u=np.asarray(qj["L_u"]).transpose(2, 0, 1),
        L_uu=np.asarray(qj["L_uu"]).transpose(3, 0, 1, 2),
        L_xx=np.asarray(qj["L_xx"]).transpose(3, 0, 1, 2),
        p0=np.asarray(qj["p0"]).T,
        P0=np.asarray(qj["P0"]).transpose(2, 0, 1),
        A=np.asarray(Aj).transpose(2, 0, 1).reshape(S, N, K, nx, nx),
        B=np.asarray(Bj).transpose(2, 0, 1).reshape(S, N, K, nx, nu),
    )
    for key, want in jax_port_layout.items():
        _close(got[key], want)
    assert got["L_xx"].shape == (S, N, nxf, nxf) and got["L_uu"].shape == (S, N, nuf, nuf)
