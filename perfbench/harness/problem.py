"""A configuration's problem: its scenario layouts (``bench.py``'s,
copied bit-equal through ``bench_torch.py``), its fleet and game cost built
through the program's entry points, its solver settings, and the cost's
fields as the reference reads them."""

from __future__ import annotations

import numpy as np
import torch


def swap_scenario(n, spacing=0.75, seed=0):
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
    x0 = np.zeros((n, 4))
    x0[:, :2] = pts
    xf = np.zeros((n, 4))
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


class Problem:
    """A configuration as run: ``cfg`` the configuration file's dict (with
    its ``rehearse`` values laid over it when rehearsing on the CPU)."""

    def __init__(self, cfg: dict, device: torch.device, rehearse: bool = False):
        import dpilqr_tpu_torch as dtt

        if rehearse:
            cfg = {**cfg, **cfg.get("rehearse", {})}
        self.cfg, self.device, self.dtt = cfg, device, dtt
        self.model = cfg["model"]
        self.n = int(cfg["n_agents"])
        self.dt, self.N, self.radius = float(cfg["dt"]), int(cfg["N"]), float(cfg["radius"])
        self.dtype = getattr(torch, cfg["dtype"])
        self.np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        self.fleet = dtt.homogeneous_fleet(dtt.get_model(self.model), self.n, self.dt)
        self.nx, self.nu = self.fleet.nx_p, self.fleet.nu_p
        self.n_pos = int(cfg["n_pos"])
        s = cfg["solver"]
        self.solver = s
        self.config = dtt.SolverConfig(n_lqr_iter=int(s["n_lqr_iter"]), tol=float(s["tol"]),
                                       n_ls_iter=int(s["n_ls_iter"]),
                                       ls_probe=int(s["ls_probe"]))

    def scenario(self, seed: int):
        """Start and goal states ``(n, nx)`` of the configuration's scenario."""
        sc = self.cfg["scenario"]
        if sc["layout"] == "swap":
            x0, xf = swap_scenario(self.n, spacing=sc["spacing"], seed=seed)
        elif sc["layout"] == "grid3d":
            x0, xf = grid3d_scenario(self.n, spacing=sc["spacing"], nx=self.nx, seed=seed)
        else:
            raise ValueError(f"unknown scenario layout {sc['layout']!r}")
        return x0.astype(self.np_dtype), xf.astype(self.np_dtype)

    def game_cost(self, xf):
        """The program's game cost for goals ``xf``: ``Q``, ``R``, ``Qf``
        multiples of the identity, the proximity radius and position size."""
        n, nx, nu, c = self.n, self.nx, self.nu, self.cfg
        return self.dtt.make_game_cost(
            xf, np.tile(c["Q"] * np.eye(nx), (n, 1, 1)), np.tile(c["R"] * np.eye(nu), (n, 1, 1)),
            np.tile(c["Qf"] * np.eye(nx), (n, 1, 1)), radius=self.radius,
            n_pos=np.full((n,), self.n_pos, np.int32), prox_weight=float(c["prox_weight"]),
            ref_weight=float(c["ref_weight"]), dtype=self.dtype, device=self.device)

    def reference_cost(self, xf, dtype=torch.float64) -> dict:
        """The fleet's cost as the reference reads it, one subproblem of n
        slots, made from the configuration alone (not from the program)."""
        n, nx, nu, c, dev = self.n, self.nx, self.nu, self.cfg, self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        npos = torch.full((1, n), self.n_pos, dtype=torch.int32, device=dev)
        return {"xf": t(xf)[None], "Q": t(np.tile(c["Q"] * np.eye(nx), (1, n, 1, 1))),
                "R": t(np.tile(c["R"] * np.eye(nu), (1, n, 1, 1))),
                "Qf": t(np.tile(c["Qf"] * np.eye(nx), (1, n, 1, 1))),
                "n_pos": npos, "n_pos_eval": npos.clone(), "mask": t(np.ones((1, n))),
                "radius": t([self.radius]), "prox_w": t([c["prox_weight"]]),
                "ref_w": t([c["ref_weight"]])}


def sub_cost_dict(sub_cost, dtype=torch.float64) -> dict:
    """A ``GameCost`` of the program as a dict of the reference's field
    names."""
    names = {"agent_mask": "mask", "prox_weight": "prox_w", "ref_weight": "ref_w"}
    out = {}
    for k, v in zip(sub_cost._fields, sub_cost):
        key = names.get(k, k)
        out[key] = v if key in ("n_pos", "n_pos_eval") else v.to(dtype)
    return out

