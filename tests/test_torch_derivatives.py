"""The derivative routines K5 computes its inputs with (csrc/derivatives.cuh),
compiled for the host and held against the port's torch prep, float64.

g++ builds ``csrc/derivatives_host.cpp`` (which includes the header) into a
small shared library in the port's build directory
(``cuda_build.host_build``), loaded with ctypes.  Its Jacobians must match ``models/vectorized.py``
``padded_jacobians`` (Euler-discretized, the input map scaled by the mask)
for all nine models at seeded points to 1e-12, and its cost terms -- the
gradient, the control gradient and the dense Hessians assembled from blocks
as the kernel assembles them -- must match ``quadraticize_stage_compact`` /
``quadraticize_terminal_compact`` with ``diag_embed`` and
``assemble_pair_hessian`` to 1e-12.
"""

import ctypes

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.models.integrate import euler_discretize
from dpilqr_tpu_torch.models.specs import MODEL_REGISTRY
from dpilqr_tpu_torch.models.vectorized import padded_jacobians
from dpilqr_tpu_torch.ops import costs as C
from dpilqr_tpu_torch.ops.cuda_build import CSRC_DIR, host_build

torch.set_num_threads(1)

RTOL = 1e-12
_SRC = CSRC_DIR / "derivatives_host.cpp"
_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off")


@pytest.fixture(scope="module")
def lib():
    L = ctypes.CDLL(str(host_build(_SRC, _FLAGS, "libderivatives.so")))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    L.dpilqr_host_jacobians.argtypes = [I, P, P, I, I, D, D, P, P]
    L.dpilqr_host_cost_terms.argtypes = [I, I, I, P, P, P, P, P, P, P, D, D, D,
                                         P, P, P, P]
    return L


def _p(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("spec", MODEL_REGISTRY, ids=lambda s: s.name)
def test_jacobians_match_padded_jacobians(lib, spec):
    """Every model at seeded points, in padded widths (nx_p 12, nu_p 4 as in
    a mixed fleet with a Quad12D) and in its own, for a live and a masked
    agent."""
    rng = np.random.default_rng(spec.model_id)
    dt = 0.1
    for nx, nu in ((spec.n_x, spec.n_u), (12, 4)):
        for mask in (1.0, 0.0):
            x = np.zeros(nx)
            u = np.zeros(nu)
            x[:spec.n_x] = rng.uniform(-0.8, 0.8, spec.n_x)
            u[:spec.n_u] = rng.uniform(-0.5, 0.5, spec.n_u)
            A = np.zeros((nx, nx))
            B = np.zeros((nx, nu))
            assert lib.dpilqr_host_jacobians(spec.model_id, _p(x), _p(u), nx, nu, dt,
                                             mask, _p(A), _p(B)) == 0
            Ac, Bc = padded_jacobians(spec.name, torch.as_tensor(x), torch.as_tensor(u))
            A_t, B_t = euler_discretize(Ac, Bc, dt)
            _close(A, A_t.numpy())
            _close(B, (B_t * mask).numpy())


def _cost_case(names, seed, packed):
    """A fleet of ``names`` with seeded weights (non-symmetric Q, R), a
    masked agent, mixed position sizes and a state where pairs lie inside
    the radius (``packed``) or some outside."""
    fleet = dtt.Fleet.from_names(names, 0.1)
    n, nx, nu = fleet.n_agents, fleet.nx_p, fleet.nu_p
    rng = np.random.default_rng(seed)
    spread = 0.3 if packed else 1.5
    x = rng.uniform(-spread, spread, (n, nx))
    u = rng.normal(size=(n, nu))
    Q = rng.uniform(0.2, 1.0, (n, nx, nx))
    R = rng.uniform(0.2, 1.0, (n, nu, nu))
    mask = np.ones(n)
    mask[-1] = 0.0
    cost = C.make_game_cost(
        rng.normal(size=(n, nx)), Q, R, 10.0 * Q, radius=0.6,
        n_pos=np.array(fleet.n_pos, np.int32), agent_mask=mask, prox_weight=150.0,
        ref_weight=1.3, dtype=torch.float64, device="cpu")
    return cost, x, u


FLEETS = {
    "unicycles": (["Unicycle4D"] * 5, True),
    "quad6d": (["Quad6D"] * 4, True),
    "mixed9": ([s.name for s in MODEL_REGISTRY], True),
    "spread": (["Unicycle4D", "Car3D", "Bike5D", "DoubleInt4D"], False),
}


@pytest.mark.parametrize("terminal", [False, True], ids=["stage", "terminal"])
@pytest.mark.parametrize("case", sorted(FLEETS))
def test_cost_terms_match_quadraticize(lib, case, terminal):
    names, packed = FLEETS[case]
    cost, x, u = _cost_case(names, len(names), packed)
    n, nx = x.shape
    nu = u.shape[1]
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    if terminal:
        L_x, L_xx_d, H = C.quadraticize_terminal_compact(cost, xt)
        L_u = L_uu = None
        Q = cost.Qf
    else:
        L_x, L_u, L_xx_d, L_uu, H = C.quadraticize_stage_compact(cost, xt, ut)
        Q = cost.Q
    L_xx = C.diag_embed(L_xx_d) + C.assemble_pair_hessian(H, n, nx)
    if not terminal:
        # Precondition: some pair is inside the radius.
        assert float(C.proximity_cost(cost, xt)) > 0 or not packed
    f = {k: np.ascontiguousarray(getattr(cost, k).numpy())
         for k in ("xf", "R", "agent_mask")}
    Qn = np.ascontiguousarray(Q.numpy())
    npos = np.ascontiguousarray(cost.n_pos.numpy())
    lx = np.zeros((n, nx))
    lu = np.zeros((n, nu))
    Lxx = np.zeros((n * nx, n * nx))
    Luu = np.zeros((n * nu, n * nu))
    assert lib.dpilqr_host_cost_terms(
        n, nx, nu, _p(x), None if terminal else _p(u), _p(f["xf"]), _p(Qn),
        _p(f["R"]), _p(f["agent_mask"]), _p(npos), float(cost.ref_weight),
        float(cost.radius), float(cost.prox_weight), _p(lx), _p(lu), _p(Lxx),
        _p(Luu)) == 0
    _close(lx, L_x.numpy())
    _close(Lxx, L_xx.reshape(n * nx, n * nx).numpy())
    if not terminal:
        _close(lu, L_u.numpy())
        _close(Luu, C.diag_embed(L_uu).reshape(n * nu, n * nu).numpy())
