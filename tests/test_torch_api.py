"""The port's reference-shaped facade (``dpilqr_tpu_torch.api``) on the CPU.

The cases of ``tests/test_api.py`` run against the port with
``device="cpu"``; then the facade is held against ``dpilqr_tpu.api`` on
identical numpy input in float64 (equal iterations and converged flags; X,
U and J within 1e-9 of the largest value), and the router that sends a
custom model to the kernels' custom-model build (a ``SymbolicModel``) or
refuses it (a spec with only ``f``) is checked.
"""

import numpy as np
import pytest
import torch

from dpilqr_tpu import api as japi
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch import api
from dpilqr_tpu_torch.models.specs import ModelSpec
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops import sweeps
from dpilqr_tpu_torch.ops.cuda_build import launch_counts, require_kernel_models

torch.set_num_threads(1)
CPU = "cpu"
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _reset_ids():
    api._reset_ids()
    japi._reset_ids()
    yield
    api._reset_ids()
    japi._reset_ids()


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale, float(np.abs(a - b).max()) / scale


# ---------------------------------------------------------- tests/test_api.py
def _single_unicycle(m, device=None, verbose=False):
    dt, N = 0.05, 50
    x = np.array([-10.0, 10, 10, 0])
    x_goal = np.zeros((4, 1)).T
    kw = {} if device is None else {"device": device}
    dynamics = m.UnicycleDynamics4D(dt, **kw)
    Q = np.diag([1.0, 1, 0, 0])
    Qf = 1000 * np.eye(4)
    cost = m.ReferenceCost(x_goal, Q, np.eye(2), Qf)
    prob = m.ilqrProblem(dynamics, cost)
    return m.ilqrSolver(prob, N).solve(x, verbose=verbose)


def test_single_unicycle_example():
    X, U, J = _single_unicycle(api, CPU)
    assert X.shape == (51, 4)
    assert U.shape == (50, 2)
    assert np.linalg.norm(X[-1][:2]) < 0.1
    assert J < 3500


def test_multi_model_ids_and_split():
    dt = 0.1
    ids = [100, 101, 102]
    models = [api.UnicycleDynamics4D(dt, id_, device=CPU) for id_ in ids]
    dynamics = api.MultiDynamicalModel(models)
    assert dynamics.ids == ids
    graph = {100: [100, 101], 101: [100, 101], 102: [102]}
    subs = dynamics.split(graph)
    assert [m.n_players for m in subs] == [2, 2, 1]
    assert subs[0].ids == [100, 101]
    assert all(s.device == CPU for s in subs)


def test_multi_linearize_dense_block_diag():
    dt = 0.1
    dynamics = api.MultiDynamicalModel(
        [api.DoubleIntDynamics4D(dt, device=CPU), api.DoubleIntDynamics4D(dt, device=CPU)]
    )
    A, B = dynamics.linearize(np.zeros(8), np.zeros(4))
    assert A.shape == (8, 8) and B.shape == (8, 4)
    assert np.allclose(A[:4, 4:], 0) and np.allclose(A[4:, :4], 0)
    assert np.isclose(A[0, 2], dt)


def test_game_cost_quadraticize_matches_core():
    n, nx, nu = 2, 4, 2
    rng = np.random.default_rng(0)
    xf = rng.normal(size=(n * nx))
    rcs = [
        api.ReferenceCost(xf[i * nx : (i + 1) * nx], np.eye(nx), np.eye(nu))
        for i in range(n)
    ]
    prox = api.ProximityCost([nx] * n, 5.0, [2, 2], device=CPU)
    game = api.GameCost(rcs, prox)
    x = rng.normal(size=(n * nx))
    u = rng.normal(size=(n * nu))
    L_x, L_u, L_xx, L_uu, L_ux = game.quadraticize(x, u)
    assert L_x.shape == (n * nx,)
    # Cross-check against the tensor core's quadraticization.
    from dpilqr_tpu_torch.ops import costs as C

    fleet = dtt.homogeneous_fleet(dtt.DOUBLE_INT_4D, n, 0.1)
    spec = game.to_array_spec(fleet, CPU)
    cx, cu, cxx, cuu = C.quadraticize_stage(
        spec, torch.as_tensor(x.reshape(n, nx)), torch.as_tensor(u.reshape(n, nu))
    )
    assert np.allclose(L_x, cx.numpy().reshape(-1))
    assert np.allclose(L_u, cu.numpy().reshape(-1))
    assert np.allclose(L_xx, cxx.numpy().reshape(n * nx, n * nx))
    # prox coupling appears off-diagonal when within radius
    d = np.linalg.norm(x[:2] - x[nx : nx + 2])
    assert d < 5.0 and not np.allclose(L_xx[:2, nx : nx + 2], 0)
    # ... and equals the JAX facade's.
    jgame = japi.GameCost(
        [japi.ReferenceCost(rc.xf, rc.Q, rc.R) for rc in rcs],
        japi.ProximityCost([nx] * n, 5.0, [2, 2]),
    )
    for a, b in zip(game.quadraticize(x, u), jgame.quadraticize(x, u)):
        _close(a, b, 1e-12)
    assert np.isclose(game(x, u), jgame(x, u), rtol=1e-12)


def test_prox_cost_values():
    prox = api.ProximityCost([3, 3], 10.0, [2, 2], device=CPU)
    x = np.array([0.0, 0, 0, 1, 2, 0])
    assert np.isclose(prox(x), (np.hypot(1, 2) - 10.0) ** 2)
    assert api.ProximityCost([2], 10.0)([1, 2]) == 0.0


def _two_double_ints(m, device=None):
    dt, N, radius = 0.1, 15, 0.5
    ids = [100, 101]
    kw = {} if device is None else {"device": device}
    dynamics = m.MultiDynamicalModel(
        [m.DoubleIntDynamics4D(dt, id_, **kw) for id_ in ids]
    )
    x0 = np.array([-1.0, 0.1, 0, 0, 1.0, -0.1, 0, 0])
    xf = np.array([1.0, 0.1, 0, 0, -1.0, -0.1, 0, 0])
    rcs = [
        m.ReferenceCost(xf[4 * i : 4 * (i + 1)], np.eye(4), np.eye(2),
                        100 * np.eye(4), id_)
        for i, id_ in enumerate(ids)
    ]
    game = m.GameCost(rcs, m.ProximityCost([4, 4], radius, [2, 2]))
    return m.ilqrProblem(dynamics, game), x0, N, radius


def test_solve_distributed_facade():
    prob, x0, N, radius = _two_double_ints(api, CPU)
    U = np.zeros((N, 4))
    X_dec, U_dec, J, info = api.solve_distributed(prob, x0[None], U, radius)
    assert X_dec.shape == (N + 1, 8)
    assert U_dec.shape == (N, 4)
    assert set(info) == {100, 101}
    assert np.isfinite(J)


def test_extract_and_ids_validation():
    dt = 0.1
    ids = [7, 9]
    dynamics = api.MultiDynamicalModel(
        [api.UnicycleDynamics4D(dt, id_, device=CPU) for id_ in ids]
    )
    rcs = [
        api.ReferenceCost(np.zeros(4), np.eye(4), np.eye(2), id=id_)
        for id_ in ids
    ]
    game = api.GameCost(rcs, api.ProximityCost([4, 4], 1.0, [2, 2]))
    prob = api.ilqrProblem(dynamics, game)
    X = np.arange(2 * 8).reshape(2, 8).astype(float)
    U = np.arange(2 * 4).reshape(2, 4).astype(float)
    Xi, Ui = prob.extract(X, U, 9)
    assert np.allclose(Xi, X[:, 4:8])
    with pytest.raises(IndexError):
        prob.extract(X, U, 123)


def test_define_inter_graph_threshold():
    ids = [100, 101, 102]
    X = np.zeros((1, 12))
    X[0, 0:2] = [0, 0]
    X[0, 4:6] = [0.9, 0]
    X[0, 8:10] = [50, 50]
    graph = api.define_inter_graph_threshold(X, 0.5, [4, 4, 4], ids, device=CPU)
    assert graph == {100: [100, 101], 101: [100, 101], 102: [102]}


def test_receding_horizon_controller():
    dt, N = 0.1, 20
    dynamics = api.DoubleIntDynamics4D(dt, device=CPU)
    cost = api.ReferenceCost(np.zeros(4), np.eye(4), np.eye(2), 100 * np.eye(4))
    prob = api.ilqrProblem(dynamics, cost)
    solver = api.ilqrSolver(prob, N)
    rhc = api.RecedingHorizonController(np.array([2.0, 2, 0, 0]), solver, 2)
    steps = 0
    for X, U, J in rhc.solve(np.zeros((N, 2)), J_converge=5.0, verbose=False):
        steps += 1
        if steps > 30:
            break
    assert steps < 30
    assert np.linalg.norm(rhc.x[:2]) < 0.5


def test_selfish_warmstart_facade():
    dt, N = 0.1, 10
    ids = [0, 1]
    dynamics = api.MultiDynamicalModel(
        [api.UnicycleDynamics4D(dt, id_, device=CPU) for id_ in ids]
    )
    xf = np.array([1.0, 1, 0, 0, -1.0, 1, 0, 0])
    rcs = [
        api.ReferenceCost(xf[4 * i : 4 * (i + 1)], np.eye(4), np.eye(2),
                          100 * np.eye(4), id_)
        for i, id_ in enumerate(ids)
    ]
    game = api.GameCost(rcs, api.ProximityCost([4, 4], 0.5, [2, 2]))
    prob = api.ilqrProblem(dynamics, game)
    U = prob.selfish_warmstart(np.zeros(8), N)
    assert U.shape == (N, 4)
    assert np.abs(U).max() > 0


def _user_bike(m, device=None):
    import sympy as sym

    kw = {} if device is None else {"device": device}

    class UserBike(m.SymbolicModel):
        def __init__(self, dt, id=None):
            super().__init__(5, 2, dt, id, **kw)
            x = sym.Matrix(sym.symbols("p_x p_y v theta phi"))
            u = sym.Matrix(sym.symbols("a rho"))
            x_dot = sym.Matrix(
                [
                    x[2] * sym.cos(x[3]),
                    x[2] * sym.sin(x[3]),
                    u[0],
                    x[2] * sym.tan(x[4]),
                    u[1],
                ]
            )
            self._build(x, u, x_dot)

    return UserBike(0.1)


def test_symbolic_model_extensibility():
    """SymbolicModel (reference dynamics.py:95-114): a user-defined sympy
    model matches the equivalent built-in and runs through the torch core."""
    pytest.importorskip("sympy")
    dt = 0.1
    m = _user_bike(api, CPU)
    ref = api.BikeDynamics5D(dt, device=CPU)
    x = np.array([1.0, 2.0, 0.5, 0.3, 0.1])
    u = np.array([0.2, -0.1])
    assert np.allclose(m.f(x, u), ref.f(x, u))
    A, B = m.linearize(x, u)
    Ar, Br = ref.linearize(x, u)
    assert np.allclose(A, Ar) and np.allclose(B, Br)
    assert np.allclose(m(x, u), ref(x, u))
    # The torch vector field the core runs is the built-in bicycle's.
    xt, ut = torch.as_tensor(np.stack([x, 2 * x])), torch.as_tensor(np.stack([u, u]))
    _close(m.spec.f(xt, ut).numpy(), dtt.BIKE_5D.f(xt, ut).numpy(), 1e-15)

    # End-to-end through the tensor core (Fleet built from the custom spec).
    rc = api.ReferenceCost(np.zeros(5), np.eye(5), 0.1 * np.eye(2), id=m.id)
    prob = api.ilqrProblem(api.MultiDynamicalModel([m]), api.GameCost([rc]))
    X, U, J = api.ilqrSolver(prob, 20).solve(x, verbose=False)
    assert X.shape == (21, 5) and np.isfinite(J)
    assert np.linalg.norm(X[-1][:2]) < np.linalg.norm(x[:2])


def test_quadraticize_distance_matches_core():
    """quadraticize_distance (reference cost.py:269-315) agrees with
    finite differences and is zero outside the radius."""
    r = 2.0
    for nd in (2, 3):
        z_a, z_b = (0.3, -0.1) if nd == 3 else (0.0, 0.0)
        pa, pb = api.Point(0.1, -0.2, z_a), api.Point(0.4, 0.3, z_b)
        L_x, L_xx = api.quadraticize_distance(pa, pb, r, nd)
        assert L_x.shape == (nd,) and L_xx.shape == (nd, nd)
        a = np.array([pa.x, pa.y, pa.z])[:nd]
        b = np.array([pb.x, pb.y, pb.z])[:nd]

        def pen(p):
            d = np.linalg.norm(p - b)
            return min(0.0, d - r) ** 2

        eps = 1e-6
        g_fd = np.array(
            [
                (pen(a + eps * np.eye(nd)[i]) - pen(a - eps * np.eye(nd)[i]))
                / (2 * eps)
                for i in range(nd)
            ]
        )
        assert np.allclose(L_x, g_fd, atol=1e-5)
        jx, jxx = japi.quadraticize_distance(
            japi.Point(pa.x, pa.y, pa.z), japi.Point(pb.x, pb.y, pb.z), r, nd)
        assert np.array_equal(L_x, jx) and np.array_equal(L_xx, jxx)
    L_x, L_xx = api.quadraticize_distance(api.Point(0, 0), api.Point(5, 5), 1.0, 2)
    assert not L_x.any() and not L_xx.any()


def test_finite_difference_helpers():
    """quadraticize_finite_difference (reference cost.py:318-349) and
    linearize_finite_difference (dynamics.py:281-290) vs analytic paths."""
    rc = api.ReferenceCost(np.arange(4.0), np.diag([1.0, 2, 3, 4]), np.eye(2))
    x, u = np.array([0.5, -1.0, 2.0, 0.1]), np.array([0.3, -0.2])
    L_x, L_u, L_xx, L_uu, L_ux = rc.quadraticize(x, u)
    F_x, F_u, F_xx, F_uu, F_ux = api.quadraticize_finite_difference(rc, x, u)
    assert np.allclose(L_x, F_x, atol=1e-4)
    assert np.allclose(L_u, F_u, atol=1e-4)
    assert np.allclose(L_xx, F_xx, atol=1e-2)
    assert np.allclose(L_uu, F_uu, atol=1e-2)

    m = api.UnicycleDynamics4D(0.1, device=CPU)
    x, u = np.array([1.0, 2.0, 0.5, 0.3]), np.array([0.2, -0.1])
    A_fd, B_fd = api.linearize_finite_difference(m.f, x, u)
    A, B = m.linearize(x, u)  # Euler-discretized
    assert np.allclose(np.eye(4) + 0.1 * A_fd, A, atol=1e-5)
    assert np.allclose(0.1 * B_fd, B, atol=1e-5)


@pytest.mark.parametrize("native", [True, False], ids=["native", "torch"])
def test_flat_kernel_surface(native, monkeypatch):
    """Model / f / integrate / linearize (reference bbdynamicswrap.pyx:8-164),
    on the native host library and on the torch models."""
    if native:
        from dpilqr_tpu_torch.native import host

        if not host.available():
            pytest.skip(f"native kernel unavailable: {host.build_error()}")
    else:
        monkeypatch.setattr(api, "_native", lambda: None)
    x, u, dt = np.array([1.0, 2.0, 0.5, 0.3]), np.array([0.1, 0.2]), 0.1
    assert int(api.Model.Unicycle4D) == 3
    xdot = api.f(x, u, api.Model.Unicycle4D, device=CPU)
    assert np.allclose(
        xdot, [0.5 * np.cos(0.3), 0.5 * np.sin(0.3), 0.1, 0.2]
    )
    xn = api.integrate(x, u, dt, api.Model.Unicycle4D, device=CPU)
    m = api.UnicycleDynamics4D(dt, device=CPU)
    assert np.allclose(xn, m(x, u), atol=1e-12)
    A, B = api.linearize(x, u, dt, api.Model.Unicycle4D, device=CPU)
    Am, Bm = m.linearize(x, u)
    assert np.allclose(A, Am) and np.allclose(B, Bm)


def test_graphics_exports():
    """The reference's graphics surface exists on the facade
    (reference __init__.py:33-39)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    for name in (
        "set_bounds",
        "plot_solve",
        "plot_interaction_graph",
        "plot_pairwise_distances",
        "make_trajectory_gif",
        "eyeball_scenario",
    ):
        assert callable(getattr(api, name))
    X = np.zeros((5, 8))
    X[:, 0] = np.linspace(0, 1, 5)
    X[:, 4] = np.linspace(1, 0, 5)
    ax = api.plot_solve(X, 12.3, np.zeros(8), [4, 4], n_d=2)
    assert ax is not None
    import matplotlib.pyplot as plt

    plt.close("all")


def _three_unicycles(m, device=None):
    dt, N, n = 0.1, 10, 3
    kw = {} if device is None else {"device": device}
    models = [m.UnicycleDynamics4D(dt, i, **kw) for i in range(n)]
    dynamics = m.MultiDynamicalModel(models)
    x0 = np.array([0.0, 0, 0, 0, 1.5, 0, 0, 0, 0, 1.5, 0, 0])
    xf = np.array([1.5, 1.5, 0, 0, 0, 1.5, 0, 0, 1.5, 0, 0, 0])
    costs = [
        m.ReferenceCost(
            xf[4 * i : 4 * (i + 1)], np.eye(4), np.eye(2), 100 * np.eye(4), i
        )
        for i in range(n)
    ]
    game = m.GameCost(costs, m.ProximityCost([4] * n, 0.5, [2] * n))
    prob = m.ilqrProblem(dynamics, game)
    return prob, np.tile(x0, (N + 1, 1)), np.zeros((N, 2 * n))


def test_solve_distributed_facade_t_kill():
    """t_kill flows through the reference-compatible facade
    (reference distributed.py:25,66-68 -> control.py:213-218)."""
    prob, X0, U0 = _three_unicycles(api, CPU)
    N, n = U0.shape[0], 3
    X, U, J, info = api.solve_distributed(prob, X0, U0, 0.5, t_kill=1e-9)
    assert X.shape == (N + 1, 4 * n) and U.shape == (N, 2 * n)
    assert np.isfinite(J)
    X2, U2, J2, _ = api.solve_distributed(prob, X0, U0, 0.5, t_kill=60.0)
    Xn, Un, Jn, _ = api.solve_distributed(prob, X0, U0, 0.5)
    assert np.isclose(J2, Jn)
    assert np.allclose(X2, Xn)


def test_solve_subproblem_facade():
    """solve_subproblem / solve_subproblem_starmap (reference
    problem.py:97-110): solve one neighborhood subproblem and extract the
    owner's slice."""
    dt, N, radius = 0.1, 10, 0.5
    ids = [100, 101, 102]
    dynamics = api.MultiDynamicalModel(
        [api.DoubleIntDynamics4D(dt, id_, device=CPU) for id_ in ids]
    )
    x0 = np.array([-1.0, 0.1, 0, 0, 1.0, -0.1, 0, 0, 0.0, 3.0, 0, 0])
    xf = np.array([1.0, 0.1, 0, 0, -1.0, -0.1, 0, 0, 0.0, -3.0, 0, 0])
    rcs = [
        api.ReferenceCost(xf[4 * i : 4 * (i + 1)], np.eye(4), np.eye(2),
                          100 * np.eye(4), id_)
        for i, id_ in enumerate(ids)
    ]
    game = api.GameCost(rcs, api.ProximityCost([4] * 3, radius, [2] * 3))
    prob = api.ilqrProblem(dynamics, game)

    graph = {100: [100, 101], 101: [100, 101]}
    sub = prob.split(graph)[0]
    x0_sub = x0[:8]
    U = np.zeros((N, 4))
    Xi, Ui, id_ = api.solve_subproblem((sub, x0_sub, U, 100, False))
    assert id_ == 100
    assert Xi.shape == (N + 1, 4) and Ui.shape == (N, 2)
    assert np.isfinite(Xi).all()
    Xi2, Ui2, id2 = api.solve_subproblem_starmap(sub, x0_sub, U, 100)
    assert id2 == 100
    np.testing.assert_allclose(Xi2, Xi, atol=1e-10)
    np.testing.assert_allclose(Ui2, Ui, atol=1e-10)


def test_facade_runs_on_the_card_unless_told():
    """With no device named anywhere the facade computes on the card; where
    there is none it raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    m = api.UnicycleDynamics4D(0.1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        m(np.zeros(4), np.zeros(2))


# ------------------------------------------- parity with dpilqr_tpu.api
def _printed(capsys):
    """``(iterations, converged)`` of each solve line ``ilqrSolver.solve``
    printed."""
    out = []
    for line in capsys.readouterr().out.splitlines():
        if "\tconverged: " in line:
            it = int(line.split("/")[0])
            out.append((it, line.endswith("True")))
    return out


def test_parity_ilqr_solver_single_unicycle(capsys):
    Xt, Ut, Jt = _single_unicycle(api, CPU, verbose=True)
    it_t = _printed(capsys)
    Xj, Uj, Jj = _single_unicycle(japi, verbose=True)
    it_j = _printed(capsys)
    assert it_t == it_j and len(it_t) == 1
    _close(Xt, Xj)
    _close(Ut, Uj)
    _close(Jt, Jj)


def _six_agents(m, device=None):
    rng = np.random.default_rng(5)
    n, dt, radius = 6, 0.1, 0.5
    x0, xf = dtt.random_setup(n, 4, rng=rng, energy=5.0, n_d=2)
    kw = {} if device is None else {"device": device}
    ids = list(range(10, 10 + n))
    dyn = m.MultiDynamicalModel([m.UnicycleDynamics4D(dt, i, **kw) for i in ids])
    rcs = [m.ReferenceCost(xf[i], np.eye(4), np.eye(2), 1e3 * np.eye(4), ids[i])
           for i in range(n)]
    game = m.GameCost(rcs, m.ProximityCost([4] * n, radius, [2] * n))
    return m.ilqrProblem(dyn, game), x0.reshape(-1), radius


def _recorded(m, monkeypatch):
    """Wrap ``m``'s core ``solve_distributed`` to keep each result."""
    got = []
    core = m._parallel.solve_distributed

    def rec(*a, **k):
        got.append(core(*a, **k))
        return got[-1]

    monkeypatch.setattr(m._parallel, "solve_distributed", rec)
    return got


def test_parity_solve_distributed_six_agents(monkeypatch):
    N = 20
    rt, rj = _recorded(api, monkeypatch), _recorded(japi, monkeypatch)
    U0 = np.random.default_rng(1).uniform(size=(N, 12)) * 0.01
    prob_t, x0, radius = _six_agents(api, CPU)
    Xt, Ut, Jt, it = api.solve_distributed(prob_t, x0[None], U0, radius)
    prob_j, _, _ = _six_agents(japi)
    Xj, Uj, Jj, ij = japi.solve_distributed(prob_j, x0[None], U0, radius)
    assert set(it) == set(ij) == set(range(10, 16))
    assert {k: v[1] for k, v in it.items()} == {k: v[1] for k, v in ij.items()}
    assert max(len(v[1]) for v in it.values()) > 1  # the agents couple
    np.testing.assert_array_equal(rt[0].iters.numpy(), np.asarray(rj[0].iters))
    np.testing.assert_array_equal(rt[0].converged.numpy(), np.asarray(rj[0].converged))
    _close(Xt, Xj)
    _close(Ut, Uj)
    _close(Jt, Jj)


def test_parity_receding_horizon_controller(capsys):
    def run(m, **kw):
        dyn = m.UnicycleDynamics4D(0.1, **kw)
        cost = m.ReferenceCost(np.zeros(4), np.eye(4), np.eye(2), 100 * np.eye(4))
        solver = m.ilqrSolver(m.ilqrProblem(dyn, cost), 20)
        rhc = m.RecedingHorizonController(np.array([2.0, 1.0, 0.5, 0.3]), solver, 1)
        steps = []
        for X, U, J in rhc.solve(np.zeros((20, 2)), J_converge=0.0, verbose=True):
            steps.append((X, U, J))
            if len(steps) == 3:
                break
        return steps, rhc.x, _printed(capsys)

    st, xt, it_t = run(api, device=CPU)
    sj, xj, it_j = run(japi)
    assert it_t == it_j and len(it_t) == 3
    for (Xt, Ut, Jt), (Xj, Uj, Jj) in zip(st, sj):
        _close(Xt, Xj)
        _close(Ut, Uj)
        _close(Jt, Jj)
    _close(xt, xj)


def test_parity_solve_rhc_decomposed():
    N, dt = 15, 0.1
    logs = {"t": [], "j": []}

    def run(m, key, **kw):
        prob, x0, radius = _six_agents(m, **kw)
        return m.solve_rhc(
            prob, x0, N, radius=radius, centralized=False, J_converge=1e-3,
            t_diverge=2 * dt, rng=np.random.default_rng(0), K=6,
            log_fn=lambda s: logs[key].append(
                (np.asarray(s.iters).tolist(), s.graph)),
        )

    Xt, Ut, Jt = run(api, "t", device=CPU)
    Xj, Uj, Jj = run(japi, "j")
    assert len(logs["t"]) == 3 and logs["t"] == logs["j"]
    _close(Xt, Xj)
    _close(Ut, Uj)
    _close(Jt, Jj)


def test_parity_symbolic_model(capsys):
    pytest.importorskip("sympy")
    x = np.array([1.0, 2.0, 0.5, 0.3, 0.1])

    def run(m, **kw):
        bike = _user_bike(m, **kw)
        rc = m.ReferenceCost(np.zeros(5), np.eye(5), 0.1 * np.eye(2), id=bike.id)
        prob = m.ilqrProblem(m.MultiDynamicalModel([bike]), m.GameCost([rc]))
        return (*m.ilqrSolver(prob, 20).solve(x, verbose=True), _printed(capsys))

    Xt, Ut, Jt, it_t = run(api, device=CPU)
    Xj, Uj, Jj, it_j = run(japi)
    assert it_t == it_j
    _close(Xt, Xj)
    _close(Ut, Uj)
    _close(Jt, Jj)


# ---------------------------------------------- custom models and the kernels
def _unicycle_f(x, u):
    return torch.stack([x[..., 2] * torch.cos(x[..., 3]),
                        x[..., 2] * torch.sin(x[..., 3]), u[..., 0], u[..., 1]], -1)


CUSTOM_UNI = ModelSpec("MyUnicycle", 1000, 4, 2, f=_unicycle_f)


def test_custom_spec_keeps_builtin_equality_and_is_no_kernel_model():
    assert all(s.builtin for s in dtt.MODEL_REGISTRY)
    assert dtt.UNICYCLE_4D == dtt.MODEL_BY_NAME["Unicycle4D"]
    assert len({dtt.UNICYCLE_4D, dtt.models.specs.ModelSpec("Unicycle4D", 3, 4, 2)}) == 1
    assert not CUSTOM_UNI.builtin
    require_kernel_models(dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 3, 0.1))
    with pytest.raises(NotImplementedError, match='device="cpu"'):
        require_kernel_models(dtt.Fleet((dtt.UNICYCLE_4D, CUSTOM_UNI), 0.1))


def test_custom_spec_matches_the_builtin_on_the_twins():
    """A custom spec whose f repeats Unicycle4D gives the built-in's
    rollout and Jacobians to 1e-14 in float64."""
    n, N = 3, 12
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.normal(size=(n, 4)))
    U = torch.as_tensor(rng.normal(size=(N, n, 2)) * 0.3)
    xf = np.zeros((n, 4))
    cost = dtt.make_game_cost(xf, np.tile(np.eye(4), (n, 1, 1)),
                              np.tile(np.eye(2), (n, 1, 1)),
                              np.tile(np.eye(4), (n, 1, 1)), radius=0.5, device=CPU)
    built = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
    custom = dtt.Fleet((CUSTOM_UNI,) * n, 0.1)
    Xb, Jb = dtt.rollout(built, cost, x0, U)
    Xc, Jc = dtt.rollout(custom, cost, x0, U)
    _close(Xc.numpy(), Xb.numpy(), 1e-14)
    _close(Jc.numpy(), Jb.numpy(), 1e-14)
    for a, b in zip(custom.linearize(Xb[:-1], U), built.linearize(Xb[:-1], U)):
        _close(a.numpy(), b.numpy(), 1e-14)
    # The batched forward twin integrates the custom model too.
    mids = torch.zeros((1, n), dtype=torch.int32)
    cost_b = dtt.GameCost(*(a[None] if a.ndim else a.expand(1) for a in cost))
    X0 = x0[None, None].expand(1, N + 1, n, 4).contiguous()
    alphas = torch.ones(1, dtype=torch.float64)
    out_c = bt.forward_pass_batched_torch(custom, cost_b, mids, X0, U[None].contiguous(),
                                          None, None, alphas)
    out_b = bt.forward_pass_batched_torch(built, cost_b, mids, X0, U[None].contiguous(),
                                          None, None, alphas)
    for a, b in zip(out_c, out_b):
        _close(a.numpy(), b.numpy(), 1e-14)


def test_kernel_wrappers_refuse_a_custom_model_before_any_launch():
    """Every wrapper of K1 to K5 raises NotImplementedError for a fleet
    holding a model the kernels do not compile, before it looks at the
    tensors' device (so here too, on CPU tensors) and before any launch:
    without the guard such a model would linearize in K1, K3 and K5 as
    A = I, B = 0 with no error."""
    n, N = 2, 4
    fleet = dtt.Fleet((dtt.UNICYCLE_4D, CUSTOM_UNI), 0.1)
    cost = dtt.make_game_cost(np.zeros((n, 4)), np.tile(np.eye(4), (n, 1, 1)),
                              np.tile(np.eye(2), (n, 1, 1)),
                              np.tile(np.eye(4), (n, 1, 1)), device=CPU)
    X = torch.zeros((N + 1, n, 4), dtype=torch.float64)
    U = torch.zeros((N, n, 2), dtype=torch.float64)
    K = torch.zeros((N, 2 * n, 4 * n), dtype=torch.float64)
    d = torch.zeros((N, 2 * n), dtype=torch.float64)
    alphas = torch.ones(2, dtype=torch.float64)
    cost_b = dtt.GameCost(*(a[None] if a.ndim else a.expand(1) for a in cost))
    mids = torch.tensor([[0, 1]], dtype=torch.int32)
    mu = torch.ones(1, dtype=torch.float64)
    before = dict(launch_counts)
    calls = [
        lambda: bt.backward_pass_batched_cuda(fleet, cost_b, mids, X[None], U[None], mu),
        lambda: bt.backward_pass_batched_wide_cuda(fleet, cost_b, mids, X[None], U[None],
                                                   mu),
        lambda: bt.backward_pass_batched(fleet, cost_b, mids, X[None], U[None], mu,
                                         "cuda"),
        lambda: sweeps.backward_pass_cuda(fleet, cost, X, U, 1.0),
        lambda: sweeps.forward_pass_cuda(fleet, cost, X, U, K, d, alphas),
        lambda: sweeps.rollout_cuda(fleet, cost, X[0], U),
        lambda: bt.forward_pass_batched_cuda(fleet, cost_b, mids, X[None], U[None], None,
                                             None, alphas),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="MyUnicycle"):
            call()
    assert dict(launch_counts) == before


def _user_unicycle(m, device=None):
    """A second custom field: the unicycle as a user would write it."""
    import sympy as sym

    kw = {} if device is None else {"device": device}

    class UserUnicycle(m.SymbolicModel):
        def __init__(self, dt, id=None):
            super().__init__(4, 2, dt, id, **kw)
            x = sym.Matrix(sym.symbols("p_x p_y v theta"))
            u = sym.Matrix(sym.symbols("a omega"))
            self._build(x, u, sym.Matrix([x[2] * sym.cos(x[3]), x[2] * sym.sin(x[3]),
                                          u[0], u[1]]))

    return UserUnicycle(0.1)


def test_a_symbolic_model_is_kernel_ready():
    """The facade's custom models carry their sympy form: the router sends
    their fleet to the custom-model library (keyed by the generated
    header), where a spec with only ``f`` is refused."""
    pytest.importorskip("sympy")
    bike = _user_bike(api, CPU)
    assert bike.spec.expr is not None and not bike.spec.builtin
    header = require_kernel_models(bike._fleet)
    assert isinstance(header, str) and "case 1000: custom_rhs_1000" in header
    assert require_kernel_models(dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 2, 0.1)) is None


def test_mixed_custom_fleet_gets_library_local_ids():
    pytest.importorskip("sympy")
    from dpilqr_tpu_torch.ops import codegen

    bike, uni = _user_bike(api, CPU), _user_unicycle(api, CPU)
    fleet = dtt.Fleet((bike.spec, dtt.UNICYCLE_4D, uni.spec), 0.1)
    assert [s.model_id for s in fleet.unique_specs] == [bike.spec.model_id, 3,
                                                        uni.spec.model_id]
    assert codegen.library_ids(fleet.unique_specs) == (1000, 3, 1001)
    header = require_kernel_models(fleet)
    assert header.count("void custom_rhs_") == 2
    model = sweeps._agent_tables(fleet, torch.float64, torch.device("cpu"))[0]
    assert model.tolist() == [1000, 3, 1001]


def test_symbolic_model_solves_run_on_the_card_unless_told():
    """Given no device, a SymbolicModel's solve resolves to the card, as the
    built-ins' do; with none it raises rather than moving to the CPU."""
    pytest.importorskip("sympy")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    bike = _user_bike(api)
    x = np.array([1.0, 2.0, 0.5, 0.3, 0.1])
    rc = api.ReferenceCost(np.zeros(5), np.eye(5), 0.1 * np.eye(2), id=bike.id)
    prob = api.ilqrProblem(api.MultiDynamicalModel([bike]), api.GameCost([rc]))
    with pytest.raises(RuntimeError, match="no CUDA"):
        api.ilqrSolver(prob, 20).solve(x, verbose=False)
