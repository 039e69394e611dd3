"""Traffic kind ``trial_batch``: one client sends Monte-Carlo batches back
to back, each ``trials`` fresh scenarios of the configuration (seeds drawn
from the run's seed) solved cold as one ``solve_trials_sharded`` on one
device at the pinned width ``K``, from warm starts uniform in ``[0,
warm_start)``.  The window counts every batch completed before its time is
up (the batch that crosses it closes the window); a traced run then
profiles ``trace_units`` more batches.  Set-up solves ``warmup_units``
batches of the configuration's warm-up scenarios.

Start and goal states are made on the host before the window (numpy, as a
user holds them); the warm starts are drawn on the device from the seed in
one call, a pool of ``max_units`` batches the window cycles through.
Building the game costs, the graphs and everything after is the program's,
inside the window.  The configuration's uncontrolled agents go to the solve
as its ``ignore_mask``, as in a closed loop.
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from perfbench.harness.check import PlanItem, SolveItem
from perfbench.harness.record import Patch, Reservoir
from perfbench.harness.window import Batch


class TrialBatch:
    def __init__(self, problem, traffic: dict, seed: int, rehearse: bool = False):
        t = {**traffic, **(traffic.get("rehearse", {}) if rehearse else {})}
        self.p, self.t = problem, t
        self.T, self.K = int(t["trials"]), int(t["K"])
        units = int(t["max_units"])
        rng = np.random.default_rng(seed)
        seeds = rng.integers(0, 2**62, size=(units, self.T))
        sc = [[problem.scenario(int(s)) for s in row] for row in seeds]
        self.x0 = np.stack([[a for a, _ in row] for row in sc])  # (units, T, n, nx)
        self.xf = np.stack([[b for _, b in row] for row in sc])
        g = torch.Generator(device=problem.device)
        g.manual_seed(int(rng.integers(0, 2**62)))
        self.U = torch.rand((units, self.T, problem.N, problem.n, problem.nu), generator=g,
                            dtype=problem.dtype, device=problem.device) * float(t["warm_start"])
        # No control on a padded coordinate.
        self.U *= self._control_mask()
        self.sample = Reservoir(int(t["check_calls"]), np.random.default_rng([seed, 1]))
        self.mesh = problem.dtt.make_mesh([problem.device])
        self.items, self.plans = [], []

    def _control_mask(self):
        p = self.p
        return torch.as_tensor(p.fleet.control_mask, dtype=p.dtype, device=p.device)

    def batch(self, x0, xf, U_T):
        from dpilqr_tpu_torch.parallel.mesh import stack_costs

        p = self.p
        cost_T = stack_costs([p.game_cost(f) for f in xf])
        X_T = torch.as_tensor(x0[:, None], dtype=p.dtype, device=p.device)
        return p.dtt.solve_trials_sharded(p.fleet, cost_T, X_T, U_T, p.radius, self.mesh,
                                          self.K, ignore_mask=p.uncontrolled,
                                          config=p.config), X_T

    def warm_up(self):
        p, seed = self.p, int(self.p.cfg["warmup_seed"])
        g = torch.Generator(device=p.device)
        g.manual_seed(seed)
        for u in range(int(self.t["warmup_units"])):
            sc = [p.scenario(seed + u * self.T + i) for i in range(self.T)]
            U = torch.rand((self.T, p.N, p.n, p.nu), generator=g, dtype=p.dtype,
                           device=p.device) * float(self.t["warm_start"]) * self._control_mask()
            res, _ = self.batch(np.stack([a for a, _ in sc]), [b for _, b in sc], U)
            res.J.cpu()

    def _patch(self):
        from dpilqr_tpu_torch.parallel import mesh

        solve_b = mesh.solve_subproblems_batched
        state = {"current": None}

        def solve_subproblems_batched(fleet, cfg, sub_cost, x0_s, U_s, mids_s, enabled, **kw):
            out = solve_b(fleet, cfg, sub_cost, x0_s, U_s, mids_s, enabled, **kw)
            if state["current"] is not None:
                state["current"]["sub"] = {"cost": sub_cost, "x0": x0_s, "U": U_s, "out": out,
                                           "mids": mids_s, "enabled": enabled}
            return out

        return state, Patch((mesh, "solve_subproblems_batched", solve_subproblems_batched))

    def window(self, run, seconds: float, slice_=None):
        """Batches until ``seconds`` have passed; with ``slice_`` then
        ``trace_units`` more under the profiler."""
        units = self.x0.shape[0]
        state, patch = self._patch()

        def batch(b, traced):
            u = b % units
            rec = {"u": u}
            state["current"] = rec if self.sample.offer(rec) else None
            last = perf_counter()
            res, X_T = self.batch(self.x0[u], self.xf[u], self.U[u])
            J, iters, conv, trunc = (a.cpu().numpy() for a in (
                res.J, res.iters, res.converged, res.truncated))
            end = perf_counter()
            # The traced slice's neighbourhoods, for the rooflines' work.
            members = res.membership.cpu().numpy().reshape(-1, self.p.n) if traced else None
            if state["current"] is not None:
                rec.update(res=res, X_T=X_T)
            state["current"] = None
            run.batches.append(Batch(ms=(end - last) * 1e3, trials=self.T, K=self.K,
                                     iters=iters.reshape(-1), converged=conv.reshape(-1),
                                     truncated=int(trunc.sum()), traced=traced,
                                     members=members))
            for t in range(self.T):
                self.plans.append(PlanItem(key=(u, t), xf=self.xf[u, t], x0=self.x0[u, t],
                                           U=res.U[t], J=float(J[t])))
            return end

        t0 = perf_counter()
        b = 0
        with patch:
            while True:
                end = batch(b, False)
                b += 1
                if end - t0 >= seconds:
                    break
            run.units = b
            run.window_s = run.untraced_s = end - t0
            run.attempted = sum(x.trials for x in run.batches)
            run.failed = sum(x.truncated for x in run.batches)
            if slice_ is not None:
                slice_.start()
                for u in range(int(self.t["trace_units"])):
                    batch(b + u, True)
                run.trace = slice_.stop()
                run.trace.solves = [(x.K, x.iters, x.members) for x in run.batches
                                    if x.traced]
        self.items = []
        n = self.p.n
        for rec in self.sample.items:
            if "sub" not in rec or "res" not in rec:
                continue
            u, sub, res = rec["u"], rec["sub"], rec["res"]
            for t in range(self.T):
                lanes = slice(t * n, (t + 1) * n)
                self.items.append(SolveItem(
                    xf=self.xf[u, t], X_w=rec["X_T"][t], U_w=self.U[u, t], K=self.K,
                    sub={"cost": type(sub["cost"])(*(a[lanes] for a in sub["cost"])),
                         "x0": sub["x0"][lanes], "U": sub["U"][lanes],
                         "out": type(sub["out"])(*(a[lanes] for a in sub["out"])),
                         "mids": sub["mids"][lanes], "enabled": sub["enabled"][lanes]},
                    res=type(res)(*(a[t] for a in res)), ignore=self.p.ignore_mask))


make = TrialBatch
