"""Where the port's entry points run.

Given numpy input and no ``device`` every entry point targets the card
(``dpilqr_tpu_torch.default_device``) and raises a ``RuntimeError`` naming
the missing CUDA device where there is none; it never falls back to the
CPU.  A tensor argument keeps its device (a CPU tensor is the caller asking
for the CPU), and ``device="cpu"`` asks for it with numpy input.  The
``cuda`` cases show the default landing on the card and skip without one.
No JAX is needed: ``python -m pytest tests/test_torch_device.py -m cuda
--noconftest`` runs them on a machine without it.
"""

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.config import resolve_device

torch.set_num_threads(1)

N_AGENTS, HORIZON, DT, RADIUS = 3, 6, 0.1, 0.5


def _numpy_problem(dtype=np.float64):
    rng = np.random.default_rng(4)
    x0, xf = dtt.random_setup(N_AGENTS, 4, rng=rng, energy=3.0, n_d=2)
    n = N_AGENTS
    cost_args = (np.asarray(xf, dtype), np.tile(np.eye(4, dtype=dtype), (n, 1, 1)),
                 np.tile(np.eye(2, dtype=dtype), (n, 1, 1)),
                 np.tile(1e2 * np.eye(4, dtype=dtype), (n, 1, 1)))
    U0 = (rng.uniform(size=(HORIZON, n, 2)) * 0.01).astype(dtype)
    return np.asarray(x0, dtype), U0, cost_args


def _entry_points(device_kw, cost):
    """name -> call of each entry point on numpy input; ``device_kw`` is {}
    (the default) or {"device": ...}.  Each returns a tensor of its result
    (or the result, for ``solve_rhc``)."""
    x0, U0, cost_args = _numpy_problem()
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, N_AGENTS, DT)
    cfg = dtt.SolverConfig(n_lqr_iter=2)
    X0 = np.broadcast_to(x0[None], (HORIZON + 1, *x0.shape)).copy()
    fields = {k: np.asarray(v.cpu()) for k, v in cost._asdict().items()}
    return {
        "make_game_cost": lambda: dtt.make_game_cost(
            *cost_args, radius=RADIUS, dtype=torch.float64, **device_kw).xf,
        "game_cost_from_numpy": lambda: dtt.game_cost_from_numpy(
            fields, dtype=torch.float64, **device_kw).xf,
        "ilqr_solve": lambda: dtt.ilqr_solve(
            fleet, cost, x0, U0=U0, config=cfg, **device_kw).X,
        "ilqr_solve_steppable": lambda: dtt.ilqr_solve_steppable(
            fleet, cost, x0, U0=U0, config=cfg, t_kill=1e9, **device_kw).X,
        "make_solver": lambda: dtt.make_solver(fleet, HORIZON, cfg)(
            cost, x0, U0, **device_kw).X,
        "solve_distributed": lambda: dtt.solve_distributed(
            fleet, cost, X0, U0, RADIUS, config=cfg, **device_kw).X,
        "solve_distributed_steppable": lambda: dtt.solve_distributed_steppable(
            fleet, cost, X0, U0, RADIUS, config=cfg, t_kill=1e9, **device_kw).X,
        "selfish_warmstart": lambda: dtt.selfish_warmstart(
            fleet, cost, x0, HORIZON, config=cfg, **device_kw),
        "solve_rhc": lambda: dtt.solve_rhc(
            fleet, cost, x0, HORIZON, radius=RADIUS, centralized=False,
            J_converge=1e-3, t_diverge=0.0, config=cfg, U0=U0, **device_kw),
        "solve_rhc_centralized": lambda: dtt.solve_rhc(
            fleet, cost, x0, HORIZON, J_converge=1e-3, t_diverge=0.0, config=cfg,
            U0=U0, **device_kw),
    }


ENTRY_POINTS = (
    "game_cost_from_numpy", "ilqr_solve", "ilqr_solve_steppable", "make_game_cost",
    "make_solver", "selfish_warmstart", "solve_distributed",
    "solve_distributed_steppable", "solve_rhc", "solve_rhc_centralized",
)


def _cpu_cost():
    return dtt.make_game_cost(*_numpy_problem()[2], radius=RADIUS,
                              dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_numpy_input_without_device_needs_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points({}, _cpu_cost())[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_cpu_runs_on_the_cpu(name):
    out = _entry_points({"device": "cpu"}, _cpu_cost())[name]()
    if name.startswith("solve_rhc"):
        assert len(out.steps) == 1 and np.isfinite(out.J)
    else:
        assert out.device.type == "cpu" and bool(torch.isfinite(out).all())


def test_default_device_never_returns_the_cpu():
    assert set(_entry_points({}, _cpu_cost())) == set(ENTRY_POINTS)
    if torch.cuda.is_available():
        assert dtt.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dtt.default_device()
    # A tensor argument keeps its device; an explicit device wins.
    t = torch.zeros(2)
    assert resolve_device(None, np.zeros(2), t) == t.device
    assert resolve_device("cpu", None) == torch.device("cpu")
    assert resolve_device("meta", t) == torch.device("meta")


def test_cpu_tensors_keep_the_cpu():
    x0, U0, _ = _numpy_problem()
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, N_AGENTS, DT)
    cost, cfg = _cpu_cost(), dtt.SolverConfig(n_lqr_iter=2)
    x0_t = torch.as_tensor(x0)
    assert dtt.ilqr_solve(fleet, cost, x0_t, U0=U0, config=cfg).X.device.type == "cpu"
    assert dtt.selfish_warmstart(fleet, cost, x0_t, HORIZON, config=cfg).device.type == "cpu"
    res = dtt.solve_rhc(fleet, cost, x0_t, HORIZON, J_converge=1e-3, t_diverge=0.0,
                        config=cfg, U0=torch.as_tensor(U0))
    assert len(res.steps) == 1 and np.isfinite(res.J)
    xf_t = torch.as_tensor(_numpy_problem()[2][0])
    assert dtt.make_game_cost(xf_t, *_numpy_problem()[2][1:]).Q.device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_cuda_numpy_input_lands_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cost = dtt.make_game_cost(*_numpy_problem()[2], radius=RADIUS, dtype=torch.float64)
    assert cost.xf.is_cuda
    out = _entry_points({}, cost)[name]()
    if name.startswith("solve_rhc"):
        assert len(out.steps) == 1 and np.isfinite(out.J)
    else:
        assert out.is_cuda and bool(torch.isfinite(out).all())
