"""The comparison that decides ``correct``.

After the window the reference judges a seed-drawn sample of the solves the
window ran (``SolveItem``), and every plan the window completed
(``PlanItem``).  Every slot carries its own agent's model (a mixed fleet:
the reference evaluates each slot's model on it), and a lane whose owner is
uncontrolled (the program's ``ignore_mask``, the reference's
``ignore_ids``) is left out of the solve but its agent stays in its
neighbours' subproblems.  Each number below is compared with its limit in
the configuration's file:

- ``graph_miss``: entries of a solve's interaction graph that differ from
  the reference's (at each agent's own ``n_pos``), outside a band of 1e-5
  around the threshold where rounding decides; and neighbourhood sizes that
  differ from the graph's.  Exact: limit 0.
- ``copy_miss``: values that differ where the program only copies: the
  gathered subproblem inputs (states, warm-start controls, cost fields and
  slot masks, gathered by the reference from the harness's own cost), each
  slot's model (the program's ``mids_s``) against the harness's own fleet,
  which lanes are solved (``enabled`` against the uncontrolled agents), the
  subproblem width, the truncation flag, the owners' rows stitched into the
  plan (an uncontrolled agent's rows zero, as the reference leaves them),
  a lane left out returned with its warm start's controls, and the loop's
  advance and shift of the warm start into the next solve.  Exact: limit 0.
- ``roll_gap``: the widest gap between a returned trajectory and the
  reference's rollout (float64) of the returned controls from the same
  start, over ``1 + max |x|``: the forward kernel and the accept step's
  selection (a plan and its controls must belong together).  A lane left
  out is held to its warm start's rollout so.
- ``cost_gap``: the widest relative gap between a subproblem's returned cost
  and the reference's cost of its returned plan.
- ``joint_gap``: the widest relative gap between a stitched plan's joint
  cost (K4's rollout) or a closed loop's executed cost and the reference's.
- ``solve_short``: the reference re-solves every sampled subproblem that
  the program solved, from the same inputs in float64.  Where its solve
  improves on the warm start by more than the tolerance, a lane reads the
  share of that improvement the program's controls fall short of,
  ``(J(U_prog) - J_ref) / (J_0 - J_ref)`` clipped to [0, 1]; the number is
  the mean.  Two right solves part on ill-conditioned lanes (a line-search
  decision that rounding flips), so a lane alone is no verdict; the mean
  over hundreds is.
- ``flag_miss``: sampled lanes whose flags break the accept step's rules
  (reference control.py:150-242): a solved lane iterates at least once and
  at most ``n_lqr_iter`` times and stops for exactly one reason, converged,
  a failed line search, or the iteration cap; a lane left out does not
  iterate and carries no flag.  Exact: limit 0.  (The iteration counts
  themselves part between two right float solves by one or two on the
  tolerance's edge, and so are compared only through ``solve_short``.)

A selfish warm start (the program's ``selfish_warmstart``: one decomposed
solve at a negative radius, every agent alone) is a ``SolveItem`` too, with
its own radius and every lane solved: the reference re-solves its singleton
subproblems.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..reference import solver as ref

# The solve's improvement, relative to the warm start's cost, below which a
# lane reads nothing for ``solve_short`` (the configurations' tolerance).
MIN_GAIN = 1e-3
# Lanes re-solved together by the reference.
CHUNK = 2048
# Plans costed together by the reference.
PLAN_CHUNK = 128


@dataclass
class SolveItem:
    """One sampled decomposed solve: its inputs (``X_w (T, n, nx)``,
    ``U_w (N, n, nu)``, the width ``K`` asked for, None under auto K, and
    the goals ``xf`` the harness made), what the batched solve received and
    returned (``sub``: ``cost``, ``x0``, ``U``, ``out``), the solve's result
    ``res``, and the next solve's inputs where the loop goes on from it."""

    xf: object
    X_w: torch.Tensor
    U_w: torch.Tensor
    K: int | None
    sub: dict
    res: object
    next: tuple | None = None
    # Auto K widens a truncated solve's width and repeats its inputs.
    redo: bool = False
    # The graph's radius where it is not the configuration's (a selfish
    # warm start's), and the agents whose lanes the solve leaves out (None:
    # none).
    radius: float | None = None
    ignore: np.ndarray | None = None


@dataclass
class PlanItem:
    """A completed plan of the scenario ``key``: start ``x0 (n, nx)``,
    controls ``U (T, n, nu)``, its executed states ``X (T, n, nx)`` where
    the program returns them, and the program's cost of it."""

    key: object
    xf: object
    x0: object
    U: object
    J: float
    X: object = None


@dataclass
class Verdict:
    numbers: dict = field(default_factory=dict)
    plan_costs: list = field(default_factory=list)
    lanes: int = 0

    def lines(self, limits: dict):
        return [(k, float(v), float(limits[k])) for k, v in self.numbers.items()]

    def correct(self, limits: dict) -> bool:
        return self.lanes > 0 and all(v <= lim for _, v, lim in self.lines(limits))


def _miss(a, b) -> int:
    if tuple(a.shape) != tuple(b.shape):
        return max(a.numel(), b.numel(), 1)
    return int((a != b).sum())


def _fleet(cost1: dict) -> dict:
    """A one-subproblem fleet cost as per-agent fields and scalars."""
    return {k: (v if k in ("radius", "prox_w", "ref_w") else v[0]) for k, v in cost1.items()}


def flag_breaks(out, n_iter: int, enabled) -> int:
    """Lanes whose iteration count and flags no run of the accept step can
    leave: a solved lane (``enabled``, with ``n_iter`` > 0) iterates and
    stops for one reason, a lane left out neither iterates nor stops."""
    i = out.iters.cpu().to(torch.int64)
    c, f = out.converged.cpu().to(torch.bool), out.failed_line_search.cpu().to(torch.bool)
    capped = (i == n_iter) & ~c & ~f
    reasons = c.to(torch.int64) + f.to(torch.int64) + capped.to(torch.int64)
    solved = (i < 1) | (i > n_iter) | (reasons != 1)
    left = (i != 0) | c | f
    return int(torch.where(enabled, solved, left).sum())


def _width(kmax: int, n: int) -> int:
    return min(1 << (kmax - 1).bit_length() if kmax > 1 else 1, n)


def judge(problem, items, plans, step_size: int = 1) -> Verdict:
    dt = problem.dt
    s = problem.solver
    branches = np.array([sp.name for sp in problem.fleet.unique_specs])
    v = Verdict(numbers=dict.fromkeys(("graph_miss", "copy_miss", "roll_gap", "cost_gap",
                                       "joint_gap", "solve_short", "flag_miss"), 0.0))
    n = v.numbers
    groups = {}
    for it in items:
        res, sub, out = it.res, it.sub, it.sub["out"]
        pdt = sub["x0"].dtype
        fleet64 = problem.reference_cost(it.xf)
        ignore = torch.zeros(problem.n, dtype=torch.bool) if it.ignore is None else \
            torch.as_tensor(it.ignore, dtype=torch.bool)
        # The graph.
        radius = problem.radius if it.radius is None else it.radius
        M_ref, tie = ref.interaction_graph(it.X_w.to(torch.float64), radius, problem.n_pos)
        memb = res.membership.to(torch.bool)
        n["graph_miss"] += int(((M_ref != memb) & ~tie).sum())
        n["graph_miss"] += _miss(res.sizes.to(torch.int64), memb.sum(dim=1))
        # The gather, from the harness's own cost.
        # The gather keeps at most n slots, whatever width is asked for.
        K = (min(it.K, problem.n) if it.K is not None
             else _width(int(memb.sum(dim=1).max()), problem.n))
        if sub["x0"].shape[1] != K:
            n["copy_miss"] += 1
            continue
        idx, mem = ref.gather_plan(memb, K)
        fc = ref.cost_to(_fleet(fleet64), dtype=pdt)
        gc, gx0, gU = ref.gather(fc, it.X_w[0], it.U_w, idx, mem)
        prog = dict(zip(("xf", "Q", "R", "Qf", "radius", "n_pos", "mask", "prox_w", "ref_w",
                         "n_pos_eval"), sub["cost"]))
        n["copy_miss"] += sum(_miss(prog[k].to(gc[k].dtype), gc[k]) for k in gc)
        n["copy_miss"] += _miss(sub["x0"], gx0) + _miss(sub["U"], gU)
        n["copy_miss"] += int((branches[sub["mids"].cpu().numpy()]
                               != problem.models[idx.cpu().numpy()]).sum())
        n["copy_miss"] += _miss(sub["enabled"].cpu().to(torch.bool), ~ignore)
        n["copy_miss"] += int(bool(res.truncated) != bool((memb.sum(dim=1) > K).any()))
        # The owners' rows, stitched; an uncontrolled agent's are zero.
        keep = (~ignore).to(res.X.device)[None, :, None]
        own_X, own_U = out.X[:, :, 0].transpose(0, 1), out.U[:, :, 0].transpose(0, 1)
        n["copy_miss"] += _miss(res.X, torch.where(keep, own_X, torch.zeros_like(own_X)))
        n["copy_miss"] += _miss(res.U, torch.where(keep, own_U, torch.zeros_like(own_U)))
        # A lane left out returns the warm start it came in with.
        n["copy_miss"] += _miss(out.U[ignore.to(out.U.device)],
                                sub["U"][ignore.to(sub["U"].device)])
        # The loop's advance and shift into the next solve.
        if it.next is not None:
            Xn, Un = it.next
            if it.redo and bool(res.truncated):
                n["copy_miss"] += _miss(Xn, it.X_w) + _miss(Un, it.U_w)
            else:
                k = step_size
                n["copy_miss"] += _miss(Xn, torch.cat([res.X[k:], res.X[-1:].expand(k, -1, -1)]))
                n["copy_miss"] += _miss(Un, torch.cat([res.U[k:], torch.zeros_like(res.U[:k])]))
        # The subproblems' plans and costs.
        slots = problem.models_at(idx)
        c64 = ref.cost_to(gc, dtype=torch.float64)
        U_prog = out.U.to(torch.float64)
        X_ref = ref.rollout(slots, gx0.to(torch.float64), U_prog, dt)
        scale = 1.0 + X_ref.abs().amax(dim=(1, 2, 3))
        gap = (X_ref - out.X.to(torch.float64)).abs().amax(dim=(1, 2, 3)) / scale
        n["roll_gap"] = max(n["roll_gap"], float(gap.max()))
        J_at = ref.trajectory_cost(c64, out.X.to(torch.float64), U_prog)
        n["cost_gap"] = max(n["cost_gap"], float(((out.J.to(torch.float64) - J_at).abs()
                                                   / J_at.abs()).max()))
        n["flag_miss"] += flag_breaks(out, int(s["n_lqr_iter"]), ~ignore)
        # The solved lanes, for the reference's re-solves.
        on = (~ignore).to(gx0.device)
        J_prog = ref.trajectory_cost(c64, X_ref, U_prog)
        g = groups.setdefault(K, [])
        g.append(({k: x[on] for k, x in c64.items()}, gx0.to(torch.float64)[on],
                  gU.to(torch.float64)[on], U_prog[on], J_prog[on],
                  ref.lanes(slots, torch.nonzero(~ignore).flatten())))
        # The stitched plan's joint cost.
        Xj = ref.rollout(problem.models,
                         it.X_w[0][None].to(torch.float64), res.U[None].to(torch.float64), dt)
        Jj = ref.trajectory_cost(fleet64, Xj, res.U[None].to(torch.float64))
        n["joint_gap"] = max(n["joint_gap"], float((float(res.J) - Jj[0]).abs() / Jj[0].abs()))
    # The reference's re-solves, by width.
    short, lanes = [], 0
    for K, rows in groups.items():
        cat = [torch.cat([r[i] for r in rows]) if i else
               {k: torch.cat([r[0][k] for r in rows]) for k in rows[0][0]} for i in range(5)]
        slots = np.concatenate([r[5] for r in rows])
        for a in range(0, cat[1].shape[0], CHUNK):
            sl = slice(a, a + CHUNK)
            out = ref.solve(ref.lanes(slots, torch.arange(a, min(a + CHUNK, cat[1].shape[0]))),
                            {k: x[sl] for k, x in cat[0].items()}, cat[1][sl],
                            cat[2][sl], dt, int(s["n_lqr_iter"]), float(s["tol"]),
                            int(s["n_ls_iter"]))
            J0, Jr, Jp = out["J0"], out["J"], cat[4][sl]
            gain = J0 - Jr
            keep = gain > MIN_GAIN * J0.abs()
            short.append(torch.clamp((Jp - Jr) / gain, 0.0, 1.0)[keep])
            lanes += Jr.shape[0]
    if short:
        sh = torch.cat(short)
        n["solve_short"] = float(sh.mean()) if sh.numel() else 0.0
    v.lanes = lanes
    v.plan_costs = plan_costs(problem, plans, n)
    return v


def plan_costs(problem, plans, n: dict) -> list:
    """``(scenario key, the reference's cost)`` of each completed plan
    (float64); widens ``joint_gap`` by the program's cost of it and
    ``roll_gap`` by its executed states."""
    costs = []
    # Together only plans of one length (a closed loop's episodes end when
    # their fleet is at its goals or their time is up).
    by_len = {}
    for p in plans:
        by_len.setdefault(len(p.U), []).append(p)
    chunks = [g[a:a + PLAN_CHUNK] for g in by_len.values() for a in range(0, len(g), PLAN_CHUNK)]
    on = torch.as_tensor(~problem.ignore_mask, device=problem.device)
    for chunk in chunks:
        dev = problem.device
        c = [problem.reference_cost(p.xf) for p in chunk]
        c = {k: torch.cat([ci[k] for ci in c]) for k in c[0]}
        x0 = torch.stack([torch.as_tensor(p.x0, dtype=torch.float64, device=dev) for p in chunk])
        U = torch.stack([torch.as_tensor(p.U, dtype=torch.float64, device=dev) for p in chunk])
        X = ref.rollout(problem.models, x0, U, problem.dt)
        J = ref.trajectory_cost(c, X, U)
        for p, Xr, Jr in zip(chunk, X, J):
            costs.append((p.key, float(Jr)))
            n["joint_gap"] = max(n["joint_gap"], abs(p.J - float(Jr)) / abs(float(Jr)))
            if p.X is not None:
                # The executed states: an uncontrolled agent's rows are the
                # stitched plans' zeros.
                Xp = torch.as_tensor(p.X, dtype=torch.float64, device=dev)
                Xr = Xr[:Xp.shape[0], on]
                n["roll_gap"] = max(n["roll_gap"], float((Xr - Xp[:, on]).abs().max()
                                                         / (1.0 + Xr.abs().max())))
                n["copy_miss"] += int((Xp[:, ~on] != 0).sum())
    return costs
