"""The port's native host dynamics (``dpilqr_tpu_torch/native``): its copy of
``bbdyn.cpp`` is the JAX package's, byte for byte, and the library g++ builds
from it agrees with the port's float64 torch models at the tolerances
``tests/test_native.py`` holds the JAX models to."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.native import host

REPO = Path(__file__).resolve().parent.parent
ALL_SPECS = list(dtt.MODEL_REGISTRY)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent")
    if not host.available():
        pytest.fail(f"the native library did not build: {host.build_error()}")
    return host


def test_source_is_the_jax_packages_byte_for_byte():
    ours = (REPO / "dpilqr_tpu_torch" / "native" / "bbdyn.cpp").read_bytes()
    assert ours == (REPO / "dpilqr_tpu" / "native" / "bbdyn.cpp").read_bytes()


def test_library_builds_into_the_ports_build_directory(lib):
    path = host._library_path()
    assert path.exists()
    assert path.is_relative_to(REPO / "dpilqr_tpu_torch" / "_build" / "host")
    assert host.build_error() is None


def _xu(spec, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, spec.n_x)) * 0.4, rng.normal(size=(1, spec.n_u)) * 0.4


@pytest.mark.parametrize("spec", ALL_SPECS, ids=lambda s: s.name)
def test_f_and_step_match_torch(lib, spec):
    dt = 0.05
    fleet = dtt.homogeneous_fleet(spec, 1, dt)
    x, u = _xu(spec, spec.model_id)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(lib.f([spec.model_id], x, u), fleet.f(xt, ut).numpy(),
                               rtol=0, atol=1e-12 * max(1.0, np.abs(x).max()))
    out_torch = fleet.step(xt, ut).numpy()
    # Quad12D's large torque gains (~1/inertia = 5.7e4) amplify last-bit
    # rounding differences; compare relative to the state scale.
    scale = max(1.0, np.abs(out_torch).max())
    assert np.allclose(lib.step([spec.model_id], x, u, dt), out_torch, atol=1e-12 * scale)


@pytest.mark.parametrize("spec", ALL_SPECS, ids=lambda s: s.name)
def test_linearize_matches_torch(lib, spec):
    dt = 0.05
    fleet = dtt.homogeneous_fleet(spec, 1, dt)
    x, u = _xu(spec, 100 + spec.model_id)
    A_n, B_n = lib.linearize([spec.model_id], x, u, dt)
    A_t, B_t = fleet.linearize(torch.as_tensor(x), torch.as_tensor(u))
    assert np.allclose(A_n, A_t.numpy(), atol=1e-12), spec.name
    assert np.allclose(B_n, B_t.numpy(), atol=1e-12), spec.name


def test_batched_heterogeneous_padded(lib):
    dt = 0.1
    fleet = dtt.Fleet((dtt.QUAD_6D, dtt.CAR_3D, dtt.UNICYCLE_4D), dt)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, fleet.nx_p)) * fleet.state_mask
    u = rng.normal(size=(3, fleet.nu_p)) * fleet.control_mask
    mids = [s.model_id for s in fleet.specs]
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    assert np.allclose(lib.step(mids, x, u, dt), fleet.step(xt, ut).numpy(), atol=1e-12)
    A_n, B_n = lib.linearize(mids, x, u, dt)
    A_t, B_t = fleet.linearize(xt, ut)
    assert np.allclose(A_n, A_t.numpy(), atol=1e-12)
    assert np.allclose(B_n, B_t.numpy(), atol=1e-12)


def test_bad_input_raises(lib):
    x, u = np.zeros((2, 4)), np.zeros((2, 2))
    with pytest.raises(ValueError, match="bad model id"):
        lib.step([3, 99], x, u, 0.1)
    with pytest.raises(ValueError, match="expected"):
        lib.f([3], x, u)
