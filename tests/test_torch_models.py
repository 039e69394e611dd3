"""CPU parity of the port's dynamics (dpilqr_tpu_torch.models) with dpilqr_tpu.

The same seeded numpy states and controls go through both packages'
``Fleet.f``, ``Fleet.step`` and ``Fleet.linearize`` in float64; the port
must agree to 1e-12 (both compute exact derivatives; only rounding of a
differently associated product may differ).
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu as dtl
import dpilqr_tpu_torch as dtt

torch.set_num_threads(1)

ATOL = 1e-12


def _states(fleet, rng, lead=()):
    x = rng.uniform(-1.0, 1.0, (*lead, fleet.n_agents, fleet.nx_p))
    u = rng.uniform(-0.5, 0.5, (*lead, fleet.n_agents, fleet.nu_p))
    return x * fleet.state_mask, u * fleet.control_mask


def _fleets(names, dt=0.1):
    return (
        dtl.Fleet(tuple(names), dt),
        dtt.Fleet.from_names(names, dt),
    )


def _check(fj, ft, x, u):
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(
        ft.f(xt, ut).numpy(), np.asarray(fj.f(x, u)), rtol=0, atol=ATOL
    )
    np.testing.assert_allclose(
        ft.step(xt, ut).numpy(), np.asarray(fj.step(x, u)), rtol=0, atol=ATOL
    )
    Aj, Bj = fj.linearize(x, u)
    At, Bt = ft.linearize(xt, ut)
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("spec", [s.name for s in dtl.MODEL_REGISTRY])
def test_model_f_step_linearize(spec):
    fj, ft = _fleets([spec] * 3)
    x, u = _states(fj, np.random.default_rng(1))
    _check(fj, ft, x, u)
    # Native-dim vector field of the spec itself.
    sj, st = dtl.get_model(spec), dtt.get_model(spec)
    assert (st.model_id, st.n_x, st.n_u, st.rk4_substeps, st.n_pos) == (
        sj.model_id, sj.n_x, sj.n_u, sj.rk4_substeps, sj.n_pos
    )
    x1, u1 = x[0, : sj.n_x], u[0, : sj.n_u]
    np.testing.assert_allclose(
        st.f(torch.as_tensor(x1), torch.as_tensor(u1)).numpy(),
        np.asarray(sj.f(x1, u1)), rtol=0, atol=ATOL,
    )


def test_mixed_fleet_and_dynamic_dispatch():
    names = ["Unicycle4D", "Bike5D", "Car3D", "DoubleInt4D", "Bike5D"]
    fj, ft = _fleets(names)
    rng = np.random.default_rng(2)
    x, u = _states(fj, rng)
    _check(fj, ft, x, u)
    np.testing.assert_array_equal(ft.branch_index_array, fj.branch_index_array)
    np.testing.assert_array_equal(ft.state_mask, fj.state_mask)
    # Gathered slots with data-dependent models (the distributed layer).
    mids = np.array([1, 1, 0, 3, 2], dtype=np.int32)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    mt = torch.as_tensor(mids, dtype=torch.long)
    np.testing.assert_allclose(
        ft.step_dyn(mt, xt, ut).numpy(),
        np.asarray(fj.step_dyn(mids, x, u)), rtol=0, atol=ATOL,
    )
    Aj, Bj = fj.linearize_dyn(mids, x, u)
    At, Bt = ft.linearize_dyn(mt, xt, ut)
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=0, atol=ATOL)


def test_pad_helpers_and_specs():
    names = ["Car3D", "Quad12D", "Human6D"]
    fj, ft = _fleets(names)
    rng = np.random.default_rng(3)
    xn = rng.standard_normal(sum(fj.x_dims))
    un = rng.standard_normal((4, sum(fj.u_dims)))
    np.testing.assert_array_equal(ft.pad_states(xn), fj.pad_states(xn))
    np.testing.assert_array_equal(ft.pad_controls(un), fj.pad_controls(un))
    xp = fj.pad_states(xn)
    np.testing.assert_array_equal(ft.unpad_states(xp), fj.unpad_states(xp))
    assert dtt.GRAVITY == dtl.GRAVITY
    from dpilqr_tpu.models import specs as sj
    from dpilqr_tpu_torch.models import specs as st

    for c in ("_Q12_KF", "_Q12_KTX", "_Q12_KTY", "_Q12_KTZ", "_Q12_CX",
              "_Q12_CY", "_Q12_CZ"):
        assert getattr(st, c) == getattr(sj, c)
