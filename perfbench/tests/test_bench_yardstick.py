"""The yardstick: the plain reference against the program on the CPU in
float64 (where the two must agree to rounding), the trace's reductions, and
the frozen work counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_helpers import MODELS, load_run

load_run()  # the checkout's root on the path

from perfbench.harness import problem as hp  # noqa: E402
from perfbench.harness import trace, work  # noqa: E402
from perfbench.harness.spec import load_module  # noqa: E402
from perfbench.reference import solver as ref  # noqa: E402


@pytest.fixture
def test_models(monkeypatch):
    """The reference dynamics of the models the tests bring (``models/``),
    beside the shipped ones."""
    for path in MODELS.glob("*.py"):
        monkeypatch.setitem(ref.LOADED, path.stem, load_module(path, "test_" + path.stem))


@pytest.mark.parametrize("fleet,spacing,layout", [
    ([("Unicycle4D", 9, 2)], 0.55, "swap"),
    ([("Quad6D", 8, 3)], 0.6, "grid3d"),
    # Mixed state sizes (Car3D's 3 padded to 4), each model its own slots;
    # spaced so that the subproblems are well conditioned (five scenario
    # seeds agree to 5e-8): closer, two right float64 solves part by
    # rounding, as a homogeneous fleet's do.
    ([("DoubleInt4D", 3, 2), ("Car3D", 3, 2), ("Unicycle4D", 3, 2)], 0.9, "swap"),
])
def test_reference_agrees_with_the_program_in_float64(fleet, spacing, layout, test_models):
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.parallel import distributed
    from perfbench.harness.control import slot_models
    from perfbench.harness.record import Patch

    cfg = {"fleet": [{"model": m, "count": c, "n_pos": k} for m, c, k in fleet],
           "dt": 0.1, "N": 20, "radius": 0.5, "Q": 1.0,
           "R": 1.0, "Qf": 1000.0, "prox_weight": 200.0, "ref_weight": 1.0, "dtype": "float64",
           "scenario": {"layout": layout, "spacing": spacing},
           "solver": {"n_lqr_iter": 15, "tol": 1e-3, "n_ls_iter": 10, "ls_probe": 2}}
    p = hp.Problem(cfg, torch.device("cpu"))
    n = p.n
    x0, xf = p.scenario(1)
    seen = {}
    orig = distributed.solve_subproblems_batched

    def spy(fleet, c, sub_cost, x0_s, U_s, mids_s, enabled, **kw):
        out = orig(fleet, c, sub_cost, x0_s, U_s, mids_s, enabled, **kw)
        seen.update(cost=sub_cost, x0=x0_s, U=U_s, mids=mids_s, out=out)
        return out

    X0 = torch.as_tensor(x0)[None]
    U0 = torch.as_tensor(np.random.default_rng(0).uniform(size=(p.N, n, p.nu)) * 0.01)
    with Patch((distributed, "solve_subproblems_batched", spy)):
        res = dtt.solve_distributed(p.fleet, p.game_cost(xf), X0, U0, p.radius,
                                    config=p.config)
    M, tie = ref.interaction_graph(X0, p.radius, p.n_pos)
    assert torch.equal(M, res.membership)
    K = seen["x0"].shape[1]
    idx, mem = ref.gather_plan(M, K)
    fc = {k: (v if k in ("radius", "prox_w", "ref_w") else v[0])
          for k, v in p.reference_cost(xf).items()}
    c, gx0, gU = ref.gather(fc, X0[0], U0, idx, mem)
    assert torch.equal(gx0, seen["x0"]) and torch.equal(gU, seen["U"])
    slots = p.models_at(idx)
    assert np.array_equal(slot_models(p.fleet, seen["mids"]), p.models[idx.numpy()])
    out = ref.solve(slots, c, gx0, gU, p.dt, 15, 1e-3)
    prog = seen["out"]
    assert torch.equal(out["iters"], prog.iters) and torch.equal(out["converged"],
                                                                 prog.converged)
    assert torch.allclose(out["J"], prog.J, rtol=1e-6)
    Xj = ref.rollout(p.models, X0[0][None], res.U[None], p.dt)
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


def _graph(n, rows):
    """An ``(n, n)`` interaction graph: the diagonal and each ``(i, j)`` of
    ``rows`` both ways."""
    M = np.eye(n, dtype=bool)
    for i, js in rows.items():
        M[i, js] = M[js, i] = True
    return M


def test_needed_work_counts_each_subproblem_at_its_own_size():
    """A padded slot is waste: subproblems of 2 and 3 agents solved at the
    width 8 (one truncated neighbourhood of 9 counts at 8) need the work of
    their own sizes, and so a fleet of one model counts as it always has."""
    from types import SimpleNamespace

    n = 12
    M = _graph(n, {0: [1], 2: [3, 4], 5: [3, 4, 6, 7, 8, 9, 10, 11]})
    lanes = [0, 2, 5]  # the lanes' sizes 2, 3 and 9
    p = SimpleNamespace(N=50, nx=4, nu=2, n=n, models=np.array(["Unicycle4D"] * n),
                        ignore_mask=np.zeros(n, bool), solver={"ls_probe": 2, "n_ls_iter": 10})
    iters = np.zeros(n, int)
    iters[lanes] = (3, 5, 2)
    rest = [i for i in range(n) if i not in lanes]  # their own sizes, some iterations
    iters[rest] = 1
    run = SimpleNamespace(problem=p, trace=SimpleNamespace(solves=[(8, iters, M)]))

    def at(fam, k, a=2):
        return np.array(work.sweep_work(fam, 50, k, 4, 2, 1, a, "Unicycle4D"))

    sizes = np.minimum(M.sum(axis=1), 8)
    want = sum(i * at("backward", k) for i, k in zip(iters, sizes))
    assert np.array_equal(np.array(work.needed_work(run, "backward")), want)
    want = sum(i * at("forward", k) + at("rollout_sweep", k, 1) for i, k in zip(iters, sizes))
    assert np.array_equal(np.array(work.needed_work(run, "forward")), want)


def test_needed_work_counts_each_slot_at_its_own_model():
    """A mixed fleet: each subproblem counted at its members' models (the
    owner and its lowest-numbered neighbours, where truncated); an
    uncontrolled agent's lane, which the solve leaves out, counts nothing,
    though the agent counts in its neighbours' subproblems."""
    from types import SimpleNamespace

    names = ["Unicycle4D", "Quad6D", "Bike5D", "Quad6D", "Unicycle4D"]
    n = len(names)
    M = _graph(n, {0: [1, 2, 3], 4: [3]})
    p = SimpleNamespace(N=50, nx=6, nu=3, n=n, models=np.array(names),
                        ignore_mask=np.array([False, False, False, True, False]),
                        solver={"ls_probe": 2, "n_ls_iter": 10})
    iters = np.array([4, 2, 3, 0, 6])
    run = SimpleNamespace(problem=p, trace=SimpleNamespace(solves=[(2, iters, M)]))
    members = {0: ["Unicycle4D", "Quad6D"], 1: ["Quad6D", "Unicycle4D"],
               2: ["Bike5D", "Unicycle4D"], 4: ["Unicycle4D", "Quad6D"]}

    def at(fam, models, a=2):
        return np.array(work.sweep_work(fam, 50, len(models), 6, 3, 1, a, tuple(models)))

    want = sum(iters[i] * at("backward", m) for i, m in members.items())
    assert np.array_equal(np.array(work.needed_work(run, "backward")), want)
    want = sum(iters[i] * at("forward", m) + at("rollout_sweep", m, 1)
               for i, m in members.items())
    assert np.array_equal(np.array(work.needed_work(run, "forward")), want)
    # The counts see the models: Bike5D's single substep makes its lane's
    # forward work differ from a Unicycle4D's.
    assert not np.array_equal(at("forward", ["Bike5D", "Unicycle4D"]),
                              at("forward", ["Unicycle4D", "Unicycle4D"]))
