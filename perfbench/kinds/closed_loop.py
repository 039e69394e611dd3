"""Traffic kind ``closed_loop``: one client runs receding-horizon episodes
back to back through ``solve_rhc(..., centralized=False)``, each ended as
the configuration's ``rhc`` settings say (the source's: every agent within
``dist_converge`` of its goal in its first ``n_d`` coordinates, or
``t_diverge`` of simulated time), each step executing ``step_size``
controls.  The configuration's uncontrolled agents go to the loop as its
``ignore_mask``; ``rhc.warm_start`` is ``random`` (small random controls
from the scenario seed, the default) or ``selfish`` (the program's
``selfish_warmstart``, computed in the episode, so that its time counts in
the episode's first step).

The episodes are a pool of ``pool`` jittered scenarios of the
configuration (scenario seeds ``warmup_seed`` on, each with its own warm
start), the same for every run: the run's seed sets the order in which the
window goes through them, one random order a cycle, and which of its
solves the check samples.  A scenario's episode is a fixed amount of work,
so runs on different seeds measure the same work where the window goes
through the whole pool: a mix's pool is as large as that allows (a closed
loop's cost swings between scenarios of one configuration, as the
neighbourhoods grow and auto K widens).

The window counts every step committed before its time is up; the step
that crosses it closes the window (the loop is stopped from its step
callback, so no step runs past it).  A traced run then profiles
``trace_units`` more episodes.  Set-up runs the pool's episodes until one
captures no new iteration graph in the program's cache (at most
``warmup_units``), so that the window captures few or none.
"""

from __future__ import annotations

import sys
from time import perf_counter

import numpy as np

from perfbench.harness.check import PlanItem, SolveItem
from perfbench.harness.record import Patch, Reservoir
from perfbench.harness.window import Step, WindowClosed


class ClosedLoop:
    def __init__(self, problem, traffic: dict, seed: int, rehearse: bool = False):
        t = {**traffic, **(traffic.get("rehearse", {}) if rehearse else {})}
        self.p, self.t = problem, t
        self.rhc = problem.cfg["rhc"]
        self.step_size = int(self.rhc["step_size"])
        rng = np.random.default_rng(seed)
        base, pool = int(problem.cfg["warmup_seed"]), int(t["pool"])
        self.pool = [base + i for i in range(pool)]
        cycles = -(-int(t["max_units"]) // pool)
        self.seeds = np.concatenate([rng.permutation(self.pool) for _ in range(cycles)])
        self.scenarios = {s: problem.scenario(s) for s in self.pool}
        self.sample = Reservoir(int(t["check_calls"]), np.random.default_rng([seed, 1]))
        # The selfish warm starts' solves, sampled apart from the loop's.
        self.warm_sample = Reservoir(int(t["check_calls"]), np.random.default_rng([seed, 2]))
        warm = self.rhc.get("warm_start", "random")
        if warm not in ("random", "selfish"):
            raise ValueError(f"rhc.warm_start is 'random' or 'selfish', not {warm!r}")
        self.selfish = warm == "selfish"
        self.items, self.plans = [], []

    def episode(self, x0, xf, seed, log_fn=None):
        p = self.p
        cost = p.game_cost(xf)
        U0 = (p.dtt.selfish_warmstart(p.fleet, cost, x0, p.N, config=p.config, device=p.device)
              if self.selfish else None)
        return p.dtt.solve_rhc(
            p.fleet, cost, x0, p.N, radius=p.radius, centralized=False,
            step_size=self.step_size, dist_converge=float(self.rhc["dist_converge"]),
            n_d=int(self.rhc["n_d"]),
            t_diverge=float(self.rhc["t_diverge"]), ignore_mask=p.uncontrolled, K=self.t["K"],
            config=p.config, rng=np.random.default_rng(seed), U0=U0, log_fn=log_fn,
            device=p.device)

    def warm_up(self):
        """The pool's episodes in turn until one captures no new iteration
        graph in the program's cache, at most ``warmup_units``: the widths
        the cell's episodes reach, and no others."""
        from dpilqr_tpu_torch.ops.batched import graph_cache_info

        for u in range(int(self.t["warmup_units"])):
            s = self.pool[u % len(self.pool)]
            before = graph_cache_info()["captured"]
            self.episode(*self.scenarios[s], s)
            if u and graph_cache_info()["captured"] == before:
                break

    def _patch(self, episode_of):
        """Wrap the loop's solve and the batched solve inside it: a sampled
        call keeps its inputs, its result and the next call's inputs.  A
        selfish warm start's solve (its radius negative) is no loop solve:
        it is sampled apart, and has no next call."""
        from dpilqr_tpu_torch.parallel import distributed, rhc

        solve_d, solve_b = rhc.solve_distributed, distributed.solve_subproblems_batched
        state = {"pending": None, "current": None}

        def solve_distributed(fleet, cost, X, U, radius, K=None, **kw):
            e = episode_of()
            xf = self.scenarios[int(self.seeds[e])][1]
            if float(radius) < 0:
                item = SolveItem(xf=xf, X_w=X, U_w=U, K=K, sub={}, res=None,
                                 radius=float(radius))
                state["current"] = item if self.warm_sample.offer(item) else None
                res = solve_d(fleet, cost, X, U, radius, K=K, **kw)
                item.res, state["current"] = res, None
                return res
            pend = state["pending"]
            if pend is not None and pend[1] == e:
                pend[0].next = (X, U)
            state["pending"] = None
            item = SolveItem(xf=xf, X_w=X, U_w=U, K=K, sub={}, res=None,
                             ignore=self.p.ignore_mask)
            state["current"] = item if self.sample.offer(item) else None
            res = solve_d(fleet, cost, X, U, radius, K=K, **kw)
            if state["current"] is not None:
                item.res = res
                item.redo = self.t["K"] is None and K is not None and K < self.p.n
                state["pending"], state["current"] = (item, e), None
            return res

        def solve_subproblems_batched(fleet, cfg, sub_cost, x0_s, U_s, mids_s, enabled, **kw):
            out = solve_b(fleet, cfg, sub_cost, x0_s, U_s, mids_s, enabled, **kw)
            if state["current"] is not None:
                state["current"].sub = {"cost": sub_cost, "x0": x0_s, "U": U_s, "out": out,
                                        "mids": mids_s, "enabled": enabled}
            return out

        return Patch((rhc, "solve_distributed", solve_distributed),
                     (distributed, "solve_subproblems_batched", solve_subproblems_batched))

    def window(self, run, seconds: float, slice_=None):
        """Episodes until ``seconds`` have passed; with ``slice_`` then
        ``trace_units`` more under the profiler."""
        cur = {"e": 0, "last": 0.0, "end": 0.0, "traced": False, "open": True}
        commits = []  # the window's commits, seconds from its start
        t0 = perf_counter()

        def log_fn(info):
            now = perf_counter()
            # The traced slice's neighbourhoods, for the rooflines' work.
            members = info.membership if cur["traced"] else None
            run.steps.append(Step(ms=(now - cur["last"]) * 1e3, solve_s=info.solve_time,
                                  K=int(info.K), iters=np.asarray(info.iters),
                                  converged=np.asarray(info.converged, dtype=bool),
                                  traced=cur["traced"], members=members))
            cur["last"] = now
            if cur["open"]:
                cur["end"] = now
                commits.append(now - t0)
                if now - t0 >= seconds:
                    raise WindowClosed

        def episode(e):
            cur["e"], cur["last"] = e, perf_counter()
            s = int(self.seeds[e])
            x0, xf = self.scenarios[s]
            res = self.episode(x0, xf, s, log_fn)
            self.plans.append(PlanItem(key=s, xf=xf, x0=x0, U=res.U, J=res.J, X=res.X))
            return perf_counter()

        e = 0
        with self._patch(lambda: cur["e"]):
            while e < len(self.seeds):
                try:
                    cur["end"] = episode(e)
                except WindowClosed:
                    e += 1
                    break
                e += 1
                run.units += 1
                if cur["end"] - t0 >= seconds:
                    break
            run.window_s = run.untraced_s = cur["end"] - t0
            run.attempted = len(run.steps)
            # Whether a run's speed drifts within its window, or only from
            # run to run (which a longer window would not average out).
            half = run.window_s / 2
            n1 = sum(c <= half for c in commits)
            if 0 < n1 < len(commits):
                print(f"perfbench: step_ms over each half of the window "
                      f"{half * 1e3 / n1:.3f} / {half * 1e3 / (len(commits) - n1):.3f}",
                      file=sys.stderr)
            if slice_ is not None:
                cur["open"], cur["traced"] = False, True
                slice_.start()
                for u in range(int(self.t["trace_units"])):
                    episode((e + u) % len(self.seeds))
                run.trace = slice_.stop()
                run.trace.solves = [(s.K, s.iters, s.members) for s in run.steps if s.traced]
        self.items = [it for it in self.sample.items + self.warm_sample.items
                      if it.res is not None and it.sub]

make = ClosedLoop
