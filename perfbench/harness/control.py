"""Stand-ins for the program's batched solve, put in its place by name for
the check's own tests (never by the benchmark's runs):

- ``control``: the reference's batched solve, rollout and joint cost
  computed in bfloat16, the precision below the configurations' float32:
  it must come out not correct;
- the faults a later change could bring (``FAULTS``): the solve returns
  its state unchanged; half of the batch is left out; an answer is altered
  where it is produced.  Each must come out not correct.

They sit where the decomposed solve, the trial batch and the loop call
``solve_subproblems_batched`` and ``rollout`` (``parallel/distributed.py``,
``parallel/mesh.py``, ``parallel/rhc.py``); graph, gather and stitch stay
the program's.  Each slot runs the model that the program's ``mids_s``
name in its fleet's branch table, so that they serve a mixed fleet too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import solver as ref
from .problem import sub_cost_dict
from .record import Patch


def _result(like, X, U, J, iters, converged, failed):
    from dpilqr_tpu_torch.ops.ilqr import SolveResult

    dt = like.dtype
    return SolveResult(X=X.to(dt), U=U.to(dt), J=J.to(dt), iters=iters.to(torch.int32),
                       converged=converged.to(torch.bool),
                       failed_line_search=failed.to(torch.bool))


def slot_models(fleet, mids_s):
    """The model name of each slot, ``(S, K)``, from the program's branch
    indices into ``fleet.unique_specs``."""
    return np.array([s.name for s in fleet.unique_specs])[mids_s.cpu().numpy()]


def control_solve(dtype=torch.bfloat16):
    """The reference's batched solve in ``dtype``, with the program's batched
    solve's signature and result."""

    def solve(fleet, cfg, sub_cost, x0_s, U0_s, mids_s, enabled, **_):
        c = sub_cost_dict(sub_cost, dtype)
        out = ref.solve(slot_models(fleet, mids_s), c, x0_s.to(dtype), U0_s.to(dtype),
                        fleet.dt, cfg.n_lqr_iter, cfg.tol, cfg.n_ls_iter, cfg.mu_init,
                        cfg.delta_0, cfg.mu_min, enabled=enabled)
        return _result(x0_s, out["X"], out["U"], out["J"], out["iters"], out["converged"],
                       out["failed"])

    return solve


def control_rollout(dtype=torch.bfloat16):
    """The reference's rollout and joint cost in ``dtype``, with the
    program's ``rollout`` signature (``ops/ilqr.py``; on the card, K4)."""

    def rollout(fleet, cost, x0, U, time_batched_cost=False):
        c = {k: (v.reshape(1) if v.dim() == 0 else v[None])
             for k, v in sub_cost_dict(cost, dtype).items()}
        X = ref.rollout([s.name for s in fleet.specs], x0[None].to(dtype), U[None].to(dtype),
                        fleet.dt)
        J = ref.trajectory_cost(c, X, U[None].to(dtype))
        return X[0].to(x0.dtype), J[0].to(x0.dtype)

    return rollout


def _unchanged(orig):
    """The solve returns its state unchanged: the warm start rolled out, its
    cost, and the iterations the solve would have reported."""

    def solve(fleet, cfg, sub_cost, x0_s, U0_s, mids_s, enabled, **kw):
        out = orig(fleet, cfg, sub_cost, x0_s, U0_s, mids_s, enabled, **kw)
        c = sub_cost_dict(sub_cost, torch.float64)
        X = ref.rollout(slot_models(fleet, mids_s), x0_s.to(torch.float64),
                        U0_s.to(torch.float64), fleet.dt)
        J = ref.trajectory_cost(c, X, U0_s.to(torch.float64))
        return _result(x0_s, X, U0_s, J, out.iters, out.converged, out.failed_line_search)

    return solve


def _half(orig):
    """Half of the batch left out: the second half's lanes keep their warm
    start, the solve runs over the rest."""

    def solve(fleet, cfg, sub_cost, x0_s, U0_s, mids_s, enabled, **kw):
        S = x0_s.shape[0]
        keep = torch.arange(S, device=x0_s.device) < (S + 1) // 2
        out = orig(fleet, cfg, sub_cost, x0_s, U0_s, mids_s, enabled & keep, **kw)
        return out

    return solve


def _altered(orig):
    """An answer altered where it is produced: one control of one lane."""

    def solve(fleet, cfg, sub_cost, x0_s, U0_s, mids_s, enabled, **kw):
        out = orig(fleet, cfg, sub_cost, x0_s, U0_s, mids_s, enabled, **kw)
        U = out.U.clone()
        U[0, 0, 0, 0] += 0.05
        return out._replace(U=U)

    return solve


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def installed(replacement=None, fault: str | None = None):
    """A ``Patch`` that puts the control (``replacement``: the reference's
    batched solve and rollout in a lower precision, ``control()``'s pair) or
    the named fault around the program's batched solve where the program
    calls them."""
    from dpilqr_tpu_torch.parallel import distributed, mesh, rhc

    if fault is not None:
        new = FAULTS[fault](distributed.solve_subproblems_batched)
        return Patch((distributed, "solve_subproblems_batched", new),
                     (mesh, "solve_subproblems_batched", new))
    solve, roll = replacement
    return Patch((distributed, "solve_subproblems_batched", solve),
                 (mesh, "solve_subproblems_batched", solve),
                 (distributed, "rollout", roll), (mesh, "rollout", roll), (rhc, "rollout", roll))


def control(dtype=torch.bfloat16):
    """The control: the reference in ``dtype`` in the place of the
    program's batched solve (K1 or K3, K2, the accept kernel) and of its
    rollout and joint cost (K4)."""
    return control_solve(dtype), control_rollout(dtype)
