"""Dynamics model registry.

Counterpart of ``dpilqr_tpu/models/specs.py``: the same nine models with the
same ids, state/control sizes, RK4 substep counts and position sizes.  Each
model's continuous-time right-hand side lives once, in the layout-agnostic
table of ``models/vectorized.py``; ``ModelSpec.f`` evaluates it on native
dimensions.  A custom model (``api.SymbolicModel``) is a spec that brings
its own ``f``: the torch path evaluates it.  The CUDA kernels compile the
nine built-in right-hand sides (``csrc/dynamics.cuh``) and, for a custom
spec that also carries its sympy form (``expr``, a ``SymbolicRHS``), a
right-hand side generated from it (``ops.codegen``); a custom spec with
only ``f`` is refused on the card (``ops.cuda_build.require_kernel_models``).
Jacobians are exact (forward-mode ``torch.func``), discretized with the
reference's forward-Euler rule ``A_d = I + dt A_c``, ``B_d = dt B_c``
(dpilqr/bbdynamics.cpp:95-106).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

# Acceleration due to gravity (reference: dpilqr/bbdynamics.cpp:11).
GRAVITY = 9.80665

# Quadrotor 12D physical constants (reference: dpilqr/bbdynamics.cpp:507-510,
# 696-707): thrust/inertia ratios and gyroscopic coupling ratios.
_Q12_KF = 2000.0 / 63.0
_Q12_KTX = 625000000000000000.0 / 10982593196059.0
_Q12_KTY = 5000000000000000000.0 / 92848985528431.0
_Q12_KTZ = 10000000000000000000.0 / 271597947137541.0
_Q12_CX = 85899976080679.0 / 175721491136944.0
_Q12_CY = 95876456000597.0 / 185697971056862.0
_Q12_CZ = 9976479919918.0 / 271597947137541.0


class TableRHS:
    """The right-hand side of a built-in model, read from the table of
    ``models/vectorized.py`` by name, on native dims ``(..., n_x), (...,
    n_u)``."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, x, u):
        from .vectorized import padded_f

        return padded_f(self.name, x, u)


@dataclass(frozen=True, eq=False)
class SymbolicRHS:
    """A custom model's continuous right-hand side in sympy: ``field[i]`` is
    dx_i/dt, an expression over the symbols ``states`` (n_x of them) and
    ``controls`` (n_u).  ``ops.codegen`` prints it as device code for the
    kernels.  Compared and hashed by identity: sympy is never touched here."""

    states: tuple
    controls: tuple
    field: tuple


@dataclass(frozen=True)
class ModelSpec:
    """Static description of one dynamics model."""

    name: str
    model_id: int
    n_x: int
    n_u: int
    # RK4 sub-steps per control period: 5 as in the reference's C++ kernel
    # (bbdynamics.cpp:49), 1 for the sympy-derived bicycle (dynamics.py:74).
    rk4_substeps: int = 5
    # Number of leading position coordinates (used by proximity coupling).
    n_pos: int = 2
    # Continuous dynamics on native dims, ``f(x (..., n_x), u (..., n_u)) ->
    # (..., n_x)``, batched over leading dims.  None: the built-in table's
    # right-hand side of ``name`` (a ``TableRHS``).  Not part of equality or
    # the hash, so the nine built-ins keep theirs.
    f: Callable | None = field(default=None, compare=False, hash=False,
                               repr=False)
    # A custom model's sympy form, from which ``ops.codegen`` generates the
    # kernels' right-hand side; None for the built-ins and for a custom spec
    # that brings only ``f`` (which then runs on the CPU only).
    expr: SymbolicRHS | None = field(default=None, compare=False, hash=False,
                                     repr=False)

    def __post_init__(self):
        if self.f is None:
            object.__setattr__(self, "f", TableRHS(self.name))

    @property
    def builtin(self) -> bool:
        """One of the nine registry models, evaluated from the table: the
        models whose right-hand sides the CUDA kernels compile."""
        return (isinstance(self.f, TableRHS)
                and 0 <= self.model_id < len(MODEL_REGISTRY)
                and MODEL_REGISTRY[self.model_id] == self)


DOUBLE_INT_4D = ModelSpec("DoubleInt4D", 0, 4, 2, n_pos=2)
DOUBLE_INT_6D = ModelSpec("DoubleInt6D", 1, 6, 3, n_pos=3)
CAR_3D = ModelSpec("Car3D", 2, 3, 2, n_pos=2)
UNICYCLE_4D = ModelSpec("Unicycle4D", 3, 4, 2, n_pos=2)
HUMAN_6D = ModelSpec("Human6D", 4, 6, 3, n_pos=3)
HUMAN_LIN_6D = ModelSpec("HumanLin6D", 5, 6, 3, n_pos=3)
QUAD_6D = ModelSpec("Quad6D", 6, 6, 3, n_pos=3)
QUAD_12D = ModelSpec("Quad12D", 7, 12, 4, n_pos=3)
BIKE_5D = ModelSpec("Bike5D", 8, 5, 2, rk4_substeps=1, n_pos=2)

MODEL_REGISTRY: tuple[ModelSpec, ...] = (
    DOUBLE_INT_4D,
    DOUBLE_INT_6D,
    CAR_3D,
    UNICYCLE_4D,
    HUMAN_6D,
    HUMAN_LIN_6D,
    QUAD_6D,
    QUAD_12D,
    BIKE_5D,
)

MODEL_BY_NAME = {spec.name: spec for spec in MODEL_REGISTRY}


def get_model(name_or_id) -> ModelSpec:
    if isinstance(name_or_id, ModelSpec):
        return name_or_id
    if isinstance(name_or_id, str):
        return MODEL_BY_NAME[name_or_id]
    return MODEL_REGISTRY[int(name_or_id)]
