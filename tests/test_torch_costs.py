"""CPU parity of the port's game cost (dpilqr_tpu_torch.ops.costs) with
dpilqr_tpu.ops.costs, float64, atol 1e-12.

The cost is built once in JAX and carried into the port by field
(``game_cost_from_numpy``), so the two packages see the same weights;
positions are drawn close enough that proximity pairs are active.
"""

import numpy as np
import pytest
import torch

from dpilqr_tpu.ops import costs as cj
from dpilqr_tpu_torch.ops import costs as ct

torch.set_num_threads(1)

ATOL = 1e-12


def _case(n, nx_p, nu_p, seed, prox_eval_n_d=None, n_pos=None, mask=None):
    rng = np.random.default_rng(seed)
    xf = rng.uniform(-1, 1, (n, nx_p))
    Q = np.stack([np.diag(rng.uniform(0.5, 2.0, nx_p)) for _ in range(n)])
    R = np.stack([np.diag(rng.uniform(0.5, 2.0, nu_p)) for _ in range(n)])
    Qf = 100.0 * Q
    cost_j = cj.make_game_cost(
        xf, Q, R, Qf, radius=0.8, n_pos=n_pos, agent_mask=mask,
        prox_eval_n_d=prox_eval_n_d,
    )
    fields = {k: np.asarray(v) for k, v in cost_j._asdict().items()}
    cost_t = ct.game_cost_from_numpy(fields, "cpu", torch.float64)
    x = 0.4 * rng.standard_normal((n, nx_p))
    u = rng.standard_normal((n, nu_p))
    return cost_j, cost_t, x, u


CASES = {
    "unicycle": dict(n=5, nx_p=4, nu_p=2, seed=0),
    "3d_positions": dict(n=4, nx_p=6, nu_p=3, seed=1,
                         n_pos=np.array([3, 3, 2, 3], np.int32)),
    "prox_eval_n_d_2": dict(n=4, nx_p=6, nu_p=3, seed=2, prox_eval_n_d=2,
                            n_pos=np.full(4, 3, np.int32)),
    "padded_slot": dict(n=4, nx_p=4, nu_p=2, seed=3,
                        mask=np.array([1.0, 1.0, 0.0, 1.0])),
    "single_agent": dict(n=1, nx_p=4, nu_p=2, seed=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cost_and_quadraticization(case):
    cost_j, cost_t, x, u = _case(**CASES[case])
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    if x.shape[0] > 1:
        # Precondition: some pair is inside the radius.
        assert float(cj.proximity_cost(cost_j, x)) > 0.0
    np.testing.assert_allclose(
        float(ct.stage_cost(cost_t, xt, ut)), float(cj.stage_cost(cost_j, x, u)),
        rtol=0, atol=ATOL,
    )
    np.testing.assert_allclose(
        float(ct.terminal_cost(cost_t, xt)), float(cj.terminal_cost(cost_j, x)),
        rtol=0, atol=ATOL,
    )
    np.testing.assert_allclose(
        float(ct.proximity_cost(cost_t, xt)),
        float(cj.proximity_cost(cost_j, x)), rtol=0, atol=ATOL,
    )
    for got, want in zip(
        ct.quadraticize_stage_compact(cost_t, xt, ut),
        cj.quadraticize_stage_compact(cost_j, x, u),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for got, want in zip(
        ct.quadraticize_terminal_compact(cost_t, xt),
        cj.quadraticize_terminal_compact(cost_j, x),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for got, want in zip(
        ct.quadraticize_stage(cost_t, xt, ut), cj.quadraticize_stage(cost_j, x, u)
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_assemble_pair_hessian_and_batching():
    cost_j, cost_t, x, u = _case(**CASES["unicycle"])
    n, nx_p = x.shape
    _, H = cj.proximity_quadraticize_compact(cost_j, x)
    H = np.asarray(H)
    np.testing.assert_allclose(
        ct.assemble_pair_hessian(torch.as_tensor(H), n, nx_p).numpy(),
        np.asarray(cj.assemble_pair_hessian(H, n, nx_p)), rtol=0, atol=ATOL,
    )
    np.testing.assert_allclose(
        ct.diag_embed(torch.as_tensor(H)).numpy(),
        np.asarray(cj.diag_embed(H)), rtol=0, atol=ATOL,
    )
    # A leading batch of states evaluates each element like the unbatched call.
    rng = np.random.default_rng(9)
    xb = x[None] + 0.1 * rng.standard_normal((3, n, nx_p))
    ub = np.broadcast_to(u, (3, *u.shape))
    got = ct.stage_cost(cost_t, torch.as_tensor(xb), torch.as_tensor(ub)).numpy()
    want = [float(cj.stage_cost(cost_j, xb[i], ub[i])) for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_make_game_cost_defaults_match():
    rng = np.random.default_rng(5)
    xf = rng.standard_normal((3, 4))
    Q = np.tile(np.eye(4), (3, 1, 1))
    R = np.tile(np.eye(2), (3, 1, 1))
    a = cj.make_game_cost(xf, Q, R, 10 * Q, radius=0.5, prox_eval_n_d=2)
    b = ct.make_game_cost(xf, Q, R, 10 * Q, radius=0.5, prox_eval_n_d=2,
                          device="cpu")
    for k in cj.GameCost._fields:
        np.testing.assert_array_equal(getattr(b, k).numpy(), np.asarray(getattr(a, k)))
