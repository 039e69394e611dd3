"""Fleet: a stacked, padded collection of dynamics models.

Counterpart of ``dpilqr_tpu/models/fleet.py``.  The joint system is held as
rectangular tensors ``x (..., n_agents, nx_p)``, ``u (..., n_agents, nu_p)``
with shorter models zero-padded; padded state components have zero dynamics
and an identity row in the discretized Jacobian (dpilqr/bbdynamics.cpp:
311-316).  Per-agent model dispatch (``lax.switch`` in the JAX package) is a
selection over the unique models, each evaluated on the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .integrate import euler_discretize, rk4_integrate
from .specs import ModelSpec, get_model
from .vectorized import padded_f, padded_jacobians, select_branches, unique_branches


@dataclass(frozen=True)
class Fleet:
    """Static fleet description: one ModelSpec per agent plus the timestep."""

    specs: tuple[ModelSpec, ...]
    dt: float

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(get_model(s) for s in self.specs))

    @classmethod
    def from_names(cls, names, dt: float) -> "Fleet":
        """Fleet from model names (or ids), e.g. ``[s.name for s in specs]``."""
        return cls(tuple(get_model(nm) for nm in names), float(dt))

    # ---- static metadata -------------------------------------------------
    @property
    def n_agents(self) -> int:
        return len(self.specs)

    @cached_property
    def nx_p(self) -> int:
        return max(s.n_x for s in self.specs)

    @cached_property
    def nu_p(self) -> int:
        return max(s.n_u for s in self.specs)

    @cached_property
    def x_dims(self) -> tuple[int, ...]:
        return tuple(s.n_x for s in self.specs)

    @cached_property
    def u_dims(self) -> tuple[int, ...]:
        return tuple(s.n_u for s in self.specs)

    @cached_property
    def n_pos(self) -> tuple[int, ...]:
        return tuple(s.n_pos for s in self.specs)

    @cached_property
    def unique_specs(self) -> tuple[ModelSpec, ...]:
        """The branch table: unique models in first-appearance order."""
        return tuple(unique_branches(self.specs))

    @cached_property
    def branch_index_array(self) -> np.ndarray:
        """(n_agents,) int32 index of each agent's model in ``unique_specs``."""
        order = {s.model_id: i for i, s in enumerate(self.unique_specs)}
        return np.array([order[s.model_id] for s in self.specs], dtype=np.int32)

    @cached_property
    def state_mask(self) -> np.ndarray:
        """(n_agents, nx_p) 1.0 where a state component is real, 0.0 in padding."""
        m = np.zeros((self.n_agents, self.nx_p))
        for i, s in enumerate(self.specs):
            m[i, : s.n_x] = 1.0
        return m

    @cached_property
    def control_mask(self) -> np.ndarray:
        m = np.zeros((self.n_agents, self.nu_p))
        for i, s in enumerate(self.specs):
            m[i, : s.n_u] = 1.0
        return m

    # ---- dynamics ----------------------------------------------------------
    def _agent_branches(self, x):
        """The static per-agent branch index, on ``x``'s device."""
        return torch.as_tensor(
            self.branch_index_array, dtype=torch.long, device=x.device
        )

    def f(self, x, u):
        """Continuous dynamics: ``(..., n, nx_p), (..., n, nu_p) -> (..., n, nx_p)``."""
        return self.f_dyn(self._agent_branches(x), x, u)

    def step(self, x, u):
        """Discrete step (RK4 over dt): ``(..., n, nx_p) -> (..., n, nx_p)``."""
        return self.step_dyn(self._agent_branches(x), x, u)

    def linearize(self, x, u):
        """Discretized Jacobians ``A (..., n, nx_p, nx_p)``, ``B (..., n, nx_p, nu_p)``."""
        return self.linearize_dyn(self._agent_branches(x), x, u)

    # Dynamic-dispatch variants: ``mids`` holds per-slot branch indices
    # (``branch_index_array`` values) broadcasting against ``x.shape[:-1]``;
    # the slot count may differ from n_agents (gathered subproblems).
    def f_dyn(self, mids, x, u):
        outs = [padded_f(s, x, u) for s in self.unique_specs]
        return select_branches(outs, mids)

    def step_dyn(self, mids, x, u):
        outs = [
            rk4_integrate(
                lambda a, b, s=s: padded_f(s, a, b),
                x, u, self.dt, s.rk4_substeps,
            )
            for s in self.unique_specs
        ]
        return select_branches(outs, mids)

    def linearize_dyn(self, mids, x, u):
        As, Bs = [], []
        for s in self.unique_specs:
            A, B = euler_discretize(*padded_jacobians(s, x, u), self.dt)
            As.append(A)
            Bs.append(B)
        return select_branches(As, mids, 2), select_branches(Bs, mids, 2)

    # ---- helpers ----------------------------------------------------------
    def pad_states(self, x_native):
        """Concatenated native-dim state vector -> (n_agents, nx_p) padded."""
        x_native = np.asarray(x_native).flatten()
        out = np.zeros((self.n_agents, self.nx_p), dtype=x_native.dtype)
        off = 0
        for i, s in enumerate(self.specs):
            out[i, : s.n_x] = x_native[off : off + s.n_x]
            off += s.n_x
        if off != x_native.size:
            raise ValueError(f"expected {off} state values, got {x_native.size}")
        return out

    def unpad_states(self, x_padded):
        """(..., n_agents, nx_p) -> (..., sum(x_dims)) concatenated native."""
        x_padded = np.asarray(x_padded)
        parts = [x_padded[..., i, : s.n_x] for i, s in enumerate(self.specs)]
        return np.concatenate(parts, axis=-1)

    def pad_controls(self, u_native):
        u_native = np.asarray(u_native)
        lead = u_native.shape[:-1]
        u_flat = u_native.reshape(*lead, -1)
        out = np.zeros((*lead, self.n_agents, self.nu_p), dtype=u_native.dtype)
        off = 0
        for i, s in enumerate(self.specs):
            out[..., i, : s.n_u] = u_flat[..., off : off + s.n_u]
            off += s.n_u
        return out

    def unpad_controls(self, u_padded):
        u_padded = np.asarray(u_padded)
        parts = [u_padded[..., i, : s.n_u] for i, s in enumerate(self.specs)]
        return np.concatenate(parts, axis=-1)


def homogeneous_fleet(model, n_agents: int, dt: float) -> Fleet:
    """Fleet of ``n_agents`` copies of one model."""
    spec = get_model(model)
    return Fleet((spec,) * n_agents, dt)
