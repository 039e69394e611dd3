"""A configuration's problem: its scenario layouts (``bench.py``'s,
copied bit-equal through ``bench_torch.py``, or a file of
``perfbench/layouts/``), its fleet and game cost built through the
program's entry points, its solver settings, and the cost's fields as the
reference reads them.

A configuration names its fleet either as ``model``, ``n_agents`` and
``n_pos`` (one controlled group) or as ``fleet``, a list of groups
``{"model": <ModelSpec name>, "count": n, "controlled": true | false,
"n_pos": k}`` laid out in order (``controlled`` defaults to true, ``n_pos``
to the model's own; an uncontrolled agent is the reference's
``ignore_ids``: its lane is not solved, but it stays in its neighbours'
subproblems).  ``Q``, ``R`` and ``Qf`` are multiples of the identity at
each agent's own state and control size, zero on the padded coordinates; a
group may give its own.  ``scenario.layout`` is ``swap``, ``grid3d`` or
the name of a file ``perfbench/layouts/<layout>.py`` whose ``make(n,
nx_p, spacing, seed, groups)`` returns the start and goal states ``(n,
nx_p)``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .spec import load_module

LAYOUTS = Path(__file__).resolve().parent.parent / "layouts"


def swap_scenario(n, spacing=0.75, seed=0, nx=4):
    """Constant-density start/goal sets with local crossings (``bench.py``
    ``_swap_scenario``): adjacent grid columns swap positions."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pts = np.stack([ii, jj], -1).reshape(-1, 2)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    col = (np.arange(n) % side)
    partner = np.where(
        (col % 2 == 0) & (col + 1 < side),
        np.arange(n) + 1,
        np.where(col % 2 == 1, np.arange(n) - 1, np.arange(n)),
    )
    partner = np.where(partner < n, partner, np.arange(n))
    goals = pts[partner] + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, nx))
    x0[:, :2] = pts
    xf = np.zeros((n, nx))
    xf[:, :2] = goals
    return x0, xf


def grid3d_scenario(n, spacing=0.75, nx=6, seed=0):
    """The quadrotor swarm's scenario (``bench.py`` ``_grid3d_scenario``):
    agents on a jittered 3D grid swap with their lateral neighbour."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1.0 / 3.0)))
    ii, jj, kk = np.meshgrid(
        np.arange(side), np.arange(side), np.arange(side), indexing="ij"
    )
    pts = np.stack([ii, jj, kk], -1).reshape(-1, 3)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    col = np.arange(n) % side
    partner = np.where(
        (col % 2 == 0) & (col + 1 < side),
        np.arange(n) + 1,
        np.where(col % 2 == 1, np.arange(n) - 1, np.arange(n)),
    )
    partner = np.where(partner < n, partner, np.arange(n))
    goals = pts[partner] + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, nx))
    x0[:, :3] = pts
    xf = np.zeros((n, nx))
    xf[:, :3] = goals
    return x0, xf


def groups_of(cfg: dict) -> list[dict]:
    """The configuration's fleet as groups with every key filled in."""
    import dpilqr_tpu_torch as dtt

    groups = cfg.get("fleet") or [{"model": cfg["model"], "count": cfg["n_agents"],
                                   "n_pos": cfg["n_pos"]}]
    return [{"controlled": True, "n_pos": dtt.get_model(g["model"]).n_pos, **g}
            for g in groups]


class Problem:
    """A configuration as run: ``cfg`` the configuration file's dict (with
    its ``rehearse`` values laid over it when rehearsing on the CPU).
    ``models`` names each agent's model."""

    def __init__(self, cfg: dict, device: torch.device, rehearse: bool = False):
        import dpilqr_tpu_torch as dtt

        if rehearse:
            cfg = {**cfg, **cfg.get("rehearse", {})}
        self.cfg, self.device, self.dtt = cfg, device, dtt
        self.groups = groups_of(cfg)
        agents = [g for g in self.groups for _ in range(int(g["count"]))]
        self.models = np.array([g["model"] for g in agents])
        self.n = len(agents)
        self.dt, self.N, self.radius = float(cfg["dt"]), int(cfg["N"]), float(cfg["radius"])
        self.dtype = getattr(torch, cfg["dtype"])
        self.np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        self.fleet = dtt.Fleet(tuple(dtt.get_model(m) for m in self.models), self.dt)
        self.nx, self.nu = self.fleet.nx_p, self.fleet.nu_p
        self.n_pos = [int(g["n_pos"]) for g in agents]
        self.ignore_mask = np.array([not g["controlled"] for g in agents])
        # The program's ``ignore_mask``, on the device, where some agent is
        # uncontrolled; else None, as the program's default.
        self.uncontrolled = (torch.as_tensor(self.ignore_mask, device=device)
                             if self.ignore_mask.any() else None)
        # Each agent's weights at its own sizes, zero on padded coordinates.
        self.Q, self.R, self.Qf = (np.zeros((self.n, d, d)) for d in (self.nx, self.nu, self.nx))
        for i, (g, spec) in enumerate(zip(agents, self.fleet.specs)):
            for W, key, d in ((self.Q, "Q", spec.n_x), (self.R, "R", spec.n_u),
                              (self.Qf, "Qf", spec.n_x)):
                W[i, :d, :d] = g.get(key, cfg[key]) * np.eye(d)
        s = cfg["solver"]
        self.solver = s
        self.config = dtt.SolverConfig(n_lqr_iter=int(s["n_lqr_iter"]), tol=float(s["tol"]),
                                       n_ls_iter=int(s["n_ls_iter"]),
                                       ls_probe=int(s["ls_probe"]))

    def models_at(self, idx):
        """The models of the agents ``idx`` (indices of any shape), one name
        an index, as the reference takes them."""
        return self.models[np.asarray(idx.cpu() if torch.is_tensor(idx) else idx)]

    def scenario(self, seed: int):
        """Start and goal states ``(n, nx)`` of the configuration's scenario."""
        sc = self.cfg["scenario"]
        if sc["layout"] == "swap":
            x0, xf = swap_scenario(self.n, spacing=sc["spacing"], seed=seed, nx=self.nx)
        elif sc["layout"] == "grid3d":
            x0, xf = grid3d_scenario(self.n, spacing=sc["spacing"], nx=self.nx, seed=seed)
        else:
            layout = load_module(LAYOUTS / f"{sc['layout']}.py",
                                 f"perfbench_layout_{sc['layout']}")
            x0, xf = layout.make(self.n, self.nx, sc["spacing"], seed,
                                                self.groups)
        return x0.astype(self.np_dtype), xf.astype(self.np_dtype)

    def game_cost(self, xf):
        """The program's game cost for goals ``xf``: each agent's ``Q``,
        ``R``, ``Qf``, the proximity radius and position sizes."""
        c = self.cfg
        return self.dtt.make_game_cost(
            xf, self.Q, self.R, self.Qf, radius=self.radius,
            n_pos=np.array(self.n_pos, np.int32), prox_weight=float(c["prox_weight"]),
            ref_weight=float(c["ref_weight"]), dtype=self.dtype, device=self.device)

    def reference_cost(self, xf, dtype=torch.float64) -> dict:
        """The fleet's cost as the reference reads it, one subproblem of n
        slots, made from the configuration alone (not from the program)."""
        n, c, dev = self.n, self.cfg, self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        npos = torch.as_tensor([self.n_pos], dtype=torch.int32, device=dev)
        return {"xf": t(xf)[None], "Q": t(self.Q)[None], "R": t(self.R)[None],
                "Qf": t(self.Qf)[None], "n_pos": npos, "n_pos_eval": npos.clone(),
                "mask": t(np.ones((1, n))), "radius": t([self.radius]),
                "prox_w": t([c["prox_weight"]]), "ref_w": t([c["ref_weight"]])}


def sub_cost_dict(sub_cost, dtype=torch.float64) -> dict:
    """A ``GameCost`` of the program as a dict of the reference's field
    names."""
    names = {"agent_mask": "mask", "prox_weight": "prox_w", "ref_weight": "ref_w"}
    out = {}
    for k, v in zip(sub_cost._fields, sub_cost):
        key = names.get(k, k)
        out[key] = v if key in ("n_pos", "n_pos_eval") else v.to(dtype)
    return out

