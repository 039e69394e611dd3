"""Custom (sympy) models in the kernels: the code generator
(``dpilqr_tpu_torch.ops.codegen``) and the right-hand sides it prints,
compiled for the host, float64.

The printer: the user bicycle of ``tests/test_torch_api.py`` gives one
device function; the same field in two instances, or under other symbol
names, gives one header with one hash; a function the printer does not take
(``besselj``) raises ``NotImplementedError`` naming it; a model wider than
the kernels' ``MAX_NX`` is not kernel-ready; and ``require_kernel_models``
routes a mixed fleet to a library whose local ids the model tables carry.

The host build: ``csrc/derivatives_host.cpp`` compiled by g++ with
``-DDPILQR_CUSTOM_MODELS -ffp-contract=off`` and the generated header on its
include path (the same ``dynamics.cuh`` and ``derivatives.cuh`` the kernels
compile, so the generated templates are instantiated on ``double`` and
``Dual<double>`` as in K1 to K5).  The generated bicycle is held at
seeded points to 1e-12 relative against four references: its torch
``spec.f``, ``padded_jacobians`` (Euler-discretized), the built-in ``Bike5D``
case of the same build, and the JAX package's ``SymbolicModel``.  A second
field, ``ALL_FUNCTIONS`` (4 states, 2 controls), uses every function the
printer supports and is held against its torch ``f`` and ``jacfwd``, at
points away from its singularities.  Skips without sympy.
"""

import ctypes

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch import api
from dpilqr_tpu_torch.models.integrate import euler_discretize
from dpilqr_tpu_torch.models.specs import ModelSpec, SymbolicRHS
from dpilqr_tpu_torch.models.vectorized import padded_jacobians
from dpilqr_tpu_torch.ops import batched as bt
from dpilqr_tpu_torch.ops import codegen, cuda_build
from dpilqr_tpu_torch.ops.cuda_build import CSRC_DIR, host_build, require_kernel_models

sym = pytest.importorskip("sympy")
torch.set_num_threads(1)

RTOL = 1e-12
DT = 0.1
_SRC = CSRC_DIR / "derivatives_host.cpp"
_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-DDPILQR_CUSTOM_MODELS")


def _bike_field(names="p_x p_y v theta phi", controls="a rho"):
    x = sym.Matrix(sym.symbols(names))
    u = sym.Matrix(sym.symbols(controls))
    return x, u, sym.Matrix([x[2] * sym.cos(x[3]), x[2] * sym.sin(x[3]), u[0],
                             x[2] * sym.tan(x[4]), u[1]])


class UserBike(api.SymbolicModel):
    """The user bicycle of tests/test_torch_api.py."""

    def __init__(self, dt, names="p_x p_y v theta phi", controls="a rho"):
        super().__init__(5, 2, dt, device="cpu")
        self._build(*_bike_field(names, controls))


class AllFunctions(api.SymbolicModel):
    """ALL_FUNCTIONS: a smooth 4-state, 2-control field calling every
    function the printer supports (sin, cos, tan, exp, log, sqrt, Abs,
    atan2, tanh, a symbolic power), integer and rational powers, a Float, a
    Rational and pi."""

    def __init__(self, dt):
        super().__init__(4, 2, dt, device="cpu")
        # Real symbols: the facade's symbolic Jacobian of Abs is then sign.
        z = sym.Matrix(sym.symbols("z0:4", real=True))
        c = sym.Matrix(sym.symbols("c0:2", real=True))
        f = sym.Matrix([
            sym.exp(-z[0] ** 2 / 2) * sym.log(1 + z[1] ** 2) + sym.atan2(z[1], 2 + z[0]),
            sym.tanh(z[2]) * sym.sqrt(1 + z[3] ** 2) + sym.Abs(z[0]) / 3
            - 1 / sym.sqrt(2 + z[1] ** 2),
            (1 + z[2] ** 2) ** c[0] - 1 / (1 + z[0] ** 2) ** 2 + sym.tan(z[3] / 4),
            sym.sin(z[1]) * sym.cos(z[2]) + sym.pi * c[1] / 3
            + sym.Float(0.25) * (2 + z[3]) ** (-3) + (1 + z[0] ** 2) ** sym.Rational(3, 2),
        ])
        self._build(z, c, f)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# ------------------------------------------------------------------ printer
def test_the_bicycle_prints_one_device_function():
    h = codegen.generate_header((UserBike(DT).spec,))
    assert h.count("void custom_rhs_") == 1 and "case 1000:" in h
    assert "d_cos(x3)" in h and "d_sin(x3)" in h and "d_tan(x4)" in h
    assert "pow(" not in h.replace("d_pow", "")


def test_one_field_is_one_header_whatever_its_instances_or_names():
    a, b = UserBike(DT), UserBike(DT)
    c = UserBike(DT, names="q0 q1 speed heading steer", controls="acc rate")
    assert len({a.spec.model_id, b.spec.model_id, c.spec.model_id}) == 3
    one = codegen.generate_header((a.spec,))
    for specs in ((a.spec, b.spec), (c.spec,), (b.spec, c.spec, a.spec)):
        h = codegen.generate_header(specs)
        assert h == one and cuda_build.build_dir(h) == cuda_build.build_dir(one)
        assert codegen.library_ids(specs) == (1000,) * len(specs)


def test_numbers_stay_in_the_instance_type_and_powers_are_products():
    h = codegen.generate_header((AllFunctions(DT).spec,))
    for fn in ("d_exp", "d_log", "d_atan2", "d_tanh", "d_sqrt", "d_abs", "d_pow",
               "d_sin", "d_cos", "d_tan"):
        assert f"{fn}(" in h, fn
    assert "T(0.25)" in h and "T(3.0 / 2.0)" in h and "T(3.141592653589793)" in h
    assert "(x0*x0)" in h
    body = h.split("#pragma once")[1]
    # No bare floating literal: each number is a T(...).
    stripped = body.replace("T(", "(")
    for lit in ("0.25", "3.141592653589793"):
        assert f"({lit})" in stripped and f" {lit}" not in body


def test_an_unsupported_function_raises_naming_it():
    x = sym.symbols("x0:2")
    u = sym.symbols("u0:1")
    spec = ModelSpec("Bessel", 2000, 2, 1, f=lambda a, b: a,
                     expr=SymbolicRHS(x, u, (sym.besselj(0, x[0]), u[0])))
    assert "besselj" in codegen.not_kernel_ready(spec)
    with pytest.raises(NotImplementedError, match="besselj"):
        codegen.generate_header((spec,))
    with pytest.raises(NotImplementedError, match="besselj"):
        require_kernel_models(dtt.Fleet((spec,), DT))


def test_a_model_past_the_kernels_widths_is_not_kernel_ready():
    x = sym.symbols("x0:13")
    u = sym.symbols("u0:1")
    spec = ModelSpec("Wide", 2001, 13, 1, f=lambda a, b: a,
                     expr=SymbolicRHS(x, u, tuple(u[0] * xi for xi in x)))
    assert "too wide" in codegen.not_kernel_ready(spec)
    with pytest.raises(NotImplementedError, match="too wide"):
        require_kernel_models(dtt.Fleet((spec,), DT))


def test_mixed_fleet_maps_to_library_local_ids():
    bike, other = UserBike(DT), AllFunctions(DT)
    fleet = dtt.Fleet((bike.spec, dtt.UNICYCLE_4D, other.spec, UserBike(DT).spec), DT)
    header = require_kernel_models(fleet)
    assert "case 1000:" in header and "case 1001:" in header
    assert "case 1002:" not in header
    assert codegen.library_ids(fleet.unique_specs) == (1000, 3, 1001, 1000)
    model, nsub, _ = bt._slot_tables(
        fleet, torch.as_tensor(fleet.branch_index_array)[None], torch.float64)
    assert model[0].tolist() == [1000, 3, 1001, 1000]
    assert nsub[0].tolist() == [1, 5, 1, 1]


# --------------------------------------------------------------- host build
@pytest.fixture(scope="module")
def host():
    """The host build of derivatives_host.cpp with the header of the
    bicycle (id 1000) and ALL_FUNCTIONS (id 1001)."""
    bike, zoo = UserBike(DT), AllFunctions(DT)
    header = codegen.generate_header((bike.spec, zoo.spec))
    L = ctypes.CDLL(str(host_build(_SRC, _FLAGS, "libderivatives_custom.so", header)))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    L.dpilqr_host_rhs.argtypes = [I, P, P, I, I, P]
    L.dpilqr_host_jacobians.argtypes = [I, P, P, I, I, D, D, P, P]
    return L, bike, zoo


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _points(n_x, n_u, seed, lo=-0.8, hi=0.8):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (8, n_x)), rng.uniform(-0.5, 0.5, (8, n_u))


def _host_rhs(L, model, x, u):
    out = np.zeros_like(x)
    for i in range(len(x)):
        assert L.dpilqr_host_rhs(model, _p(x[i]), _p(u[i]), x.shape[1], u.shape[1],
                                 _p(out[i])) == 0
    return out


def _host_jac(L, model, x, u, mask=1.0):
    A = np.zeros((len(x), x.shape[1], x.shape[1]))
    B = np.zeros((len(x), x.shape[1], u.shape[1]))
    for i in range(len(x)):
        xi, ui = np.ascontiguousarray(x[i]), np.ascontiguousarray(u[i])
        Ai, Bi = np.zeros(A.shape[1:]), np.zeros(B.shape[1:])
        assert L.dpilqr_host_jacobians(model, _p(xi), _p(ui), x.shape[1], u.shape[1], DT,
                                       mask, _p(Ai), _p(Bi)) == 0
        A[i], B[i] = Ai, Bi
    return A, B


def _torch_jac(spec, x, u):
    A, B = euler_discretize(*padded_jacobians(spec, torch.as_tensor(x),
                                              torch.as_tensor(u)), DT)
    return A.numpy(), B.numpy()


def test_generated_bicycle_matches_its_torch_f(host):
    L, bike, _ = host
    x, u = _points(5, 2, 0)
    _close(_host_rhs(L, 1000, x, u),
           bike.spec.f(torch.as_tensor(x), torch.as_tensor(u)).numpy())


def test_generated_bicycle_jacobians_match_padded_jacobians(host):
    L, bike, _ = host
    x, u = _points(5, 2, 1)
    for mask in (1.0, 0.0):
        A, B = _host_jac(L, 1000, x, u, mask)
        At, Bt = _torch_jac(bike.spec, x, u)
        _close(A, At)
        _close(B, Bt * mask)


def test_generated_bicycle_matches_the_builtin_case(host):
    L, _, _ = host
    x, u = _points(5, 2, 2)
    _close(_host_rhs(L, 1000, x, u), _host_rhs(L, 8, x, u))
    for a, b in zip(_host_jac(L, 1000, x, u), _host_jac(L, 8, x, u)):
        _close(a, b)


def test_generated_bicycle_matches_the_jax_symbolic_model(host):
    import jax
    import jax.numpy as jnp

    from dpilqr_tpu import api as japi  # (enables float64)

    class JaxBike(japi.SymbolicModel):
        def __init__(self, dt):
            super().__init__(5, 2, dt)
            self._build(*_bike_field())

    L, _, _ = host
    x, u = _points(5, 2, 3)
    fj = jax.vmap(JaxBike(DT).spec.f)
    _close(_host_rhs(L, 1000, x, u), np.asarray(fj(jnp.asarray(x), jnp.asarray(u))))


def test_all_functions_field_matches_torch_f_and_jacfwd(host):
    L, _, zoo = host
    x, u = _points(4, 2, 4, lo=0.1, hi=0.9)
    x[::2, 0] *= -1  # both sides of Abs, away from its kink
    _close(_host_rhs(L, 1001, x, u),
           zoo.spec.f(torch.as_tensor(x), torch.as_tensor(u)).numpy())
    A, B = _host_jac(L, 1001, x, u)
    At, Bt = _torch_jac(zoo.spec, x, u)
    _close(A, At)
    _close(B, Bt)


# ------------------------------------------------------------------- build
def test_custom_library_is_keyed_by_its_header_and_holds_k2_k4_k5():
    from dpilqr_tpu_torch.ops import cuda_build as cb

    one = codegen.generate_header((UserBike(DT).spec,))
    two = codegen.generate_header((UserBike(DT).spec, AllFunctions(DT).spec))
    dirs = {cb.build_dir(None), cb.build_dir(one), cb.build_dir(two)}
    assert len(dirs) == 3 and cb.build_dir(one) == cb.build_dir(one)
    assert cb.build_dir(one).parent == cb.BUILD_DIR / "custom"
    # Every kernel that differentiates or integrates a fleet: K1 and K3 now
    # compute their Jacobians too.
    assert set(cb.CUSTOM_KERNELS) == {"backward_batched", "backward_batched_wide",
                                      "backward_sweep", "forward_batched", "forward_sweep"}
    # The probes hold no model: asking for their custom build raises first.
    with pytest.raises(ValueError, match="holds no model"):
        cb.launch("probe_fma", torch.float32, torch.device("cpu"), library=one)


def test_ptxas_report_reads_registers_and_spills(tmp_path):
    from dpilqr_tpu_torch.ops import cuda_build as cb

    (tmp_path / "forward_batched.log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z22forward_batched_kernelIfLi4EEv' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z22forward_batched_kernelIfLi4EEv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 560 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z10other_kernelv' for 'sm_90a'\n"
        "ptxas info    : Used 30 registers, 380 bytes cmem[0]\n")
    report = cb.ptxas_report(tmp_path / cb.LIB_NAME, "forward_batched",
                             "forward_batched_kernel")
    assert report == {"_Z22forward_batched_kernelIfLi4EEv": (128, 8, 12)}
