"""The yardstick: the plain reference against the program on the CPU in
float64 (where the two must agree to rounding), the trace's reductions, and
the frozen work counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_helpers import load_run

load_run()  # the checkout's root on the path

from perfbench.harness import problem as hp  # noqa: E402
from perfbench.harness import trace, work  # noqa: E402
from perfbench.reference import solver as ref  # noqa: E402


@pytest.mark.parametrize("model,n,spacing", [("Unicycle4D", 9, 0.55), ("Quad6D", 8, 0.6)])
def test_reference_agrees_with_the_program_in_float64(model, n, spacing):
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.parallel import distributed
    from perfbench.harness.record import Patch

    cfg = {"model": model, "n_agents": n, "dt": 0.1, "N": 20, "radius": 0.5, "Q": 1.0,
           "R": 1.0, "Qf": 1000.0, "prox_weight": 200.0, "ref_weight": 1.0,
           "n_pos": 2 if model == "Unicycle4D" else 3, "dtype": "float64",
           "scenario": {"layout": "swap" if model == "Unicycle4D" else "grid3d",
                        "spacing": spacing},
           "solver": {"n_lqr_iter": 15, "tol": 1e-3, "n_ls_iter": 10, "ls_probe": 2}}
    p = hp.Problem(cfg, torch.device("cpu"))
    x0, xf = p.scenario(1)
    seen = {}
    orig = distributed.solve_subproblems_batched

    def spy(fleet, c, sub_cost, x0_s, U_s, mids_s, enabled, **kw):
        out = orig(fleet, c, sub_cost, x0_s, U_s, mids_s, enabled, **kw)
        seen.update(cost=sub_cost, x0=x0_s, U=U_s, out=out)
        return out

    X0 = torch.as_tensor(x0)[None]
    U0 = torch.as_tensor(np.random.default_rng(0).uniform(size=(p.N, n, p.nu)) * 0.01)
    with Patch((distributed, "solve_subproblems_batched", spy)):
        res = dtt.solve_distributed(p.fleet, p.game_cost(xf), X0, U0, p.radius,
                                    config=p.config)
    M, tie = ref.interaction_graph(X0, p.radius, [p.n_pos] * n)
    assert torch.equal(M, res.membership)
    K = seen["x0"].shape[1]
    idx, mem = ref.gather_plan(M, K)
    fc = {k: (v if k in ("radius", "prox_w", "ref_w") else v[0])
          for k, v in p.reference_cost(xf).items()}
    c, gx0, gU = ref.gather(fc, X0[0], U0, idx, mem)
    assert torch.equal(gx0, seen["x0"]) and torch.equal(gU, seen["U"])
    out = ref.solve(model, c, gx0, gU, p.dt, 15, 1e-3)
    prog = seen["out"]
    assert torch.equal(out["iters"], prog.iters) and torch.equal(out["converged"],
                                                                 prog.converged)
    assert torch.allclose(out["J"], prog.J, rtol=1e-6)
    Xj = ref.rollout(model, X0[0][None], res.U[None], p.dt)
    Jj = ref.trajectory_cost(p.reference_cost(xf), Xj, res.U[None])
    assert float(Jj[0]) == pytest.approx(float(res.J), rel=1e-10)


def test_union_and_gaps():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    t = trace.TraceData(device=[("void (anonymous namespace)::k1<float, 4>(float*)", 0, 2),
                                ("void at::k2<1>(int)", 5, 6)],
                        host=[("outer", 0, 10), ("cudaStreamSynchronize", 2.5, 4.5)],
                        window_us=10, start_us=0, end_us=10)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k1<float, 4>"
    assert b["idle_gaps"][0] == ["outer", 4e-6]
    assert b["idle_gaps"][1] == ["cudaStreamSynchronize", 3e-6]


def test_frozen_work_counts_match_the_program_today():
    from dpilqr_tpu_torch.utils import sol

    for fam in ("backward", "forward", "rollout_sweep"):
        for K, nx, nu, model in ((8, 4, 2, "Unicycle4D"), (32, 6, 3, "Quad6D")):
            assert work.sweep_work(fam, 50, K, nx, nu, 100, 2, model) == \
                sol.sweep_work(fam, 50, K, nx, nu, 100, 2, model)
    assert work.published_bound(67e12, 0) == (1.0, "operations")
    assert work.roofline_pct(0.0, 1, 1) is None


def test_needed_work_counts_each_subproblem_at_its_own_size():
    """A padded slot is waste: subproblems of 2 and 3 agents solved at the
    width 8 (one truncated neighbourhood of 9 counts at 8) need the work of
    their own sizes."""
    from types import SimpleNamespace

    p = SimpleNamespace(N=50, nx=4, nu=2, model="Unicycle4D",
                        solver={"ls_probe": 2, "n_ls_iter": 10})
    run = SimpleNamespace(problem=p, trace=SimpleNamespace(
        solves=[(8, np.array([3, 5, 2]), np.array([2, 3, 9]))]))

    def at(fam, k, a=2):
        return np.array(work.sweep_work(fam, 50, k, 4, 2, 1, a, "Unicycle4D"))

    want = 3 * at("backward", 2) + 5 * at("backward", 3) + 2 * at("backward", 8)
    assert np.array_equal(np.array(work.needed_work(run, "backward")), want)
    want = (3 * at("forward", 2) + 5 * at("forward", 3) + 2 * at("forward", 8)
            + at("rollout_sweep", 2, 1) + at("rollout_sweep", 3, 1) + at("rollout_sweep", 8, 1))
    assert np.array_equal(np.array(work.needed_work(run, "forward")), want)
