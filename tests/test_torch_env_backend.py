"""The ``DPILQR_SWEEP_BACKEND`` override of the port (``ops.ilqr.
env_sweep_backend``), the three cases of the JAX package's
``tests/test_robustness.py::TestEnvBackendValidation`` with the port's
names ("auto", "cuda", "torch", "pscan"), and the override at work in both
resolvers and in a solve."""

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.config import SWEEP_BACKENDS, resolve_backend
from dpilqr_tpu_torch.ops.ilqr import env_sweep_backend, resolve_sweep_backend


class _OnCard:
    """Stands in for a CUDA tensor: the routing reads the device and the
    element size only."""

    is_cuda = True

    def element_size(self):
        return 8


def test_typo_raises(monkeypatch):
    monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "cudaa")
    with pytest.raises(ValueError, match="DPILQR_SWEEP_BACKEND"):
        env_sweep_backend()


def test_valid_values(monkeypatch):
    for name in ("cuda", "torch", "pscan"):
        monkeypatch.setenv("DPILQR_SWEEP_BACKEND", name)
        assert env_sweep_backend() == name
    monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "auto")
    assert env_sweep_backend() is None
    monkeypatch.delenv("DPILQR_SWEEP_BACKEND")
    assert env_sweep_backend() is None
    assert SWEEP_BACKENDS == ("auto", "cuda", "torch", "pscan")


def test_resolvers_reject_typo(monkeypatch):
    # The JAX package's names are typos here.
    monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "pallas")
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 4, 0.1)
    x = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="DPILQR_SWEEP_BACKEND"):
        resolve_sweep_backend(dtt.SolverConfig(), x, fleet)
    with pytest.raises(ValueError, match="DPILQR_SWEEP_BACKEND"):
        resolve_backend("auto", x)


def test_override_wins_over_the_config(monkeypatch):
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 4, 0.1)
    cpu, card = torch.zeros(()), _OnCard()
    monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "torch")
    assert resolve_backend("cuda", card) == "torch"
    assert resolve_sweep_backend(dtt.SolverConfig(sweep_backend="cuda"), card, fleet) == "torch"
    monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "cuda")
    assert resolve_backend("torch", cpu) == "cuda"
    assert resolve_sweep_backend(dtt.SolverConfig(), cpu, fleet) == "cuda"
    monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "pscan")
    assert resolve_sweep_backend(dtt.SolverConfig(), cpu, fleet) == "pscan"
    assert resolve_backend("torch", cpu) == "torch"  # the batched solve has no scan


def test_override_reaches_a_solve(monkeypatch):
    """On CPU tensors "cuda" from the environment sends the solve to the
    kernels, whose wrappers refuse CPU tensors: the override is read."""
    n, N = 3, 5
    rng = np.random.default_rng(0)
    x0 = rng.uniform(size=(n, 4))
    cost = dtt.make_game_cost(x0 + 1.0, np.tile(np.eye(4), (n, 1, 1)),
                              np.tile(np.eye(2), (n, 1, 1)), np.tile(np.eye(4), (n, 1, 1)),
                              radius=0.5, device="cpu")
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1)
    cfg = dtt.SolverConfig(n_lqr_iter=2)
    base = dtt.ilqr_solve(fleet, cost, torch.as_tensor(x0), N=N, config=cfg)
    monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        dtt.ilqr_solve(fleet, cost, torch.as_tensor(x0), N=N, config=cfg)
    monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "torch")
    res = dtt.ilqr_solve(fleet, cost, torch.as_tensor(x0), N=N, config=cfg)
    assert torch.equal(res.X, base.X) and torch.equal(res.J, base.J)
