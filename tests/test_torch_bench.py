"""CPU tests of ``bench_torch.py``, the port's bench, and its two thin CLIs
(``scripts/torch_bench_rhc.py``, ``scripts/torch_bench_warmstart.py``).

Its builders must be ``bench.py``'s bit for bit; its cold decomposed point
and its centralized point must give the JAX package's solves on the same
inputs (float64, J within 1e-9 relative, equal iterations and flags; the
JAX side on its XLA sweeps, as the JAX tests run it on the CPU); and its
record must hold every key a point promises, one error key per failed
point and a non-zero exit code when anything failed.  Everything runs on
the CPU at a few agents and a short horizon."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch as bt
import dpilqr_tpu as dtl
from dpilqr_tpu.config import SolverConfig as ConfigJ
from dpilqr_tpu.parallel.distributed import _solve_distributed

torch.set_num_threads(1)
CPU = torch.device("cpu")
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _jax_cost(xf, n_pos=None):
    n, nx = xf.shape
    nu = 3 if nx == 6 else 4 if nx == 12 else 2
    return dtl.make_game_cost(
        jnp.asarray(xf), jnp.asarray(np.tile(np.eye(nx), (n, 1, 1))),
        jnp.asarray(np.tile(np.eye(nu), (n, 1, 1))),
        jnp.asarray(np.tile(1e3 * np.eye(nx), (n, 1, 1))), radius=0.5,
        n_pos=None if n_pos is None else np.full((n,), n_pos, np.int32),
    )


@pytest.mark.parametrize("n", [7, 50, 64, 99])
@pytest.mark.parametrize("name", ["grid", "swap", "grid3d"])
def test_builders_equal_bench_bit_for_bit(name, n):
    ours, theirs = getattr(bt, f"{name}_scenario"), getattr(bench, f"_{name}_scenario")
    for kwargs in ({}, {"spacing": 1.25, "seed": 3}):
        for a, b in zip(ours(n, **kwargs), theirs(n, **kwargs)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_chip_smoke_keeps_no_copy_of_the_builders():
    import chip_smoke

    assert chip_smoke.swap_scenario is bt.swap_scenario
    assert chip_smoke.grid3d_scenario is bt.grid3d_scenario
    assert chip_smoke.user_bike_class is bt.user_bike_class


@pytest.mark.parametrize("model,n", [("unicycle", 16), ("quad6d", 27)])
def test_closed_loop_problem_equals_bench(model, n):
    fleet_j, cost_j, x0_j = bench._cl_problem(n, 0.1, 0.5, model)
    s = bt.Setting(device=CPU, dtype=torch.float32)
    fleet, cost, x0 = bt.cl_problem(s, n, model)
    assert [sp.name for sp in fleet.specs] == [sp.name for sp in fleet_j.specs]
    np.testing.assert_array_equal(x0, x0_j)
    for field in ("xf", "Q", "R", "Qf", "n_pos", "radius"):
        got, want = getattr(cost, field).numpy(), np.asarray(getattr(cost_j, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def _jax_cold(x0, xf, N, K):
    n = x0.shape[0]
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    X0 = jnp.broadcast_to(jnp.asarray(x0)[None], (N + 1, n, 4))
    cfg = ConfigJ(n_lqr_iter=15, tol=1e-3, sweep_backend="xla")
    return _solve_distributed(fleet, cfg, K, None, _jax_cost(xf), X0,
                              jnp.zeros((N, n, 2)), jnp.asarray(0.5), jnp.zeros((n,), bool))


def test_cold_point_matches_jax_solve_distributed():
    """``distributed_50`` cut to 8 unicycles at N = 6 (K = 8) against the
    JAX package's decomposed solve of ``bench.py``'s scenario.  The mirrored
    grid sends every agent through the centre, and at N = 10 the problem is
    ill conditioned (ROADMAP C4): there the JAX solve moves J by 4.9e-3
    under a 1e-14 change of x0.  At N = 6 that change moves it by 8.8e-11
    (``tests/probe_bench_conditioning.py``)."""
    N = 6
    s = bt.Setting(device=CPU, dtype=torch.float64, horizon=N, reps=1, max_agents=8)
    fleet, cost, x0 = bt.grid_problem(s, 8)
    res = bt.cold_solve(s, fleet, cost, x0, bt.K_SLOTS)
    rj = _jax_cold(*bench._grid_scenario(8), N, bt.K_SLOTS)
    assert not bool(res.truncated) and not bool(rj.truncated)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_allclose(float(res.J), float(rj.J), rtol=1e-9)
    # The point's record is that solve.
    out = bt.POINTS["distributed_50"].run(s)
    assert out["iters_50_distributed"] == int(np.asarray(rj.iters).sum())
    assert out["conv_frac_50_distributed"] == float(np.asarray(rj.converged).mean())
    np.testing.assert_allclose(out["J_50_distributed"], float(rj.J), rtol=1e-9)
    assert out["backend_50_distributed"] == "torch"
    assert out["backward_50_distributed"] == "twin" and out["launches_50_distributed"] == {}


def test_centralized_point_matches_jax_make_solver():
    """``centralized_10`` at N = 10 in float64 against ``dpilqr_tpu.make_solver``
    on the same ``random_setup`` problem."""
    N = 10
    s = bt.Setting(device=CPU, dtype=torch.float64, horizon=N, reps=1)
    x0j, xfj = dtl.random_setup(10, 4, rng=np.random.default_rng(12345), energy=10.0, n_d=2)
    fleet, cost, x0, x0_t, solve = bt.centralized_solver(s)
    np.testing.assert_array_equal(x0, x0j)
    np.testing.assert_array_equal(cost.xf.numpy(), xfj)
    fleet_j = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 10, 0.1)
    rj = dtl.make_solver(fleet_j, N, ConfigJ(n_lqr_iter=15, tol=1e-9))(
        _jax_cost(xfj), jnp.asarray(x0j), jnp.zeros((N, 10, 2)))
    out = bt.centralized_point(s)
    assert out["iters_10_centralized"] == int(rj.iters)
    assert out["converged_10_centralized"] == bool(rj.converged)
    np.testing.assert_allclose(out["J_10_centralized"], float(rj.J), rtol=1e-9)
    assert out["backend_10_centralized"] == "torch"


# Every point the CPU can run (``sol`` needs the card), cut to a few agents.
TINY = dict(mpc_steps=2, horizon=3, max_agents=4)
CPU_POINTS = [name for name in bt.POINTS if name != "sol"]


def _run(argv, **kw):
    lines = []
    rc = bt.main(argv, emit=lines.append, **{**TINY, **kw})
    return rc, [json.loads(line) for line in lines]


def test_record_at_a_tiny_setting_holds_every_key():
    argv = ["--device", "cpu", "--dtype", "float64", "--reps", "2"]
    rc, lines = _run(argv + [a for name in CPU_POINTS for a in ("--point", name)])
    *points, rec = lines
    extra = rec["extra"]
    assert rc == 0, [k for k in extra if k.endswith("_error")]
    assert "incomplete" not in extra
    assert [p["point"] for p in points] == CPU_POINTS
    s = bt.Setting(device=CPU)
    for p in points:
        missing = [k for k in bt.expected_keys(p["point"], s) if p.get(k) is None]
        assert not missing, (p["point"], missing)
        for key in bt.POINTS[p["point"]].timed:
            assert p[f"{key}_min"] <= p[key] <= p[f"{key}_max"], key
    for key in extra:
        if key.startswith("mean_iters_"):
            tag = key[len("mean_iters_"):]
            assert extra[f"non_solve_{tag}"] == (extra[key] <= 1.0), tag
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert rec["value"] == extra["ms_100_distributed"] and rec["vs_baseline"] > 0
    assert extra["riccati_block_nnz_per_s"] > 0
    assert extra["device"] == {"name": "cpu", "count": 0, "nvidia_smi": None}
    assert extra["dtype"] == "float64" and extra["reps"] == 2


def test_canonical_keys_cover_bench_py_and_the_two_new_cells():
    canonical = {k for p in bt.POINTS.values() for k in p.canonical}
    assert canonical == set(bench_canonical()) | {"ms_trials_8x100",
                                                  "ms_per_mpc_step_bike_custom_100"}


def bench_canonical():
    """``bench.py``'s canonical key list, read from its source."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(bench.main))
    (node,) = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "canonical"]
    return ast.literal_eval(node.value)


@pytest.mark.parametrize("iters,flag", [([1, 1, 1], True), ([1, 0, 2], True),
                                        ([1, 2, 2], False)])
def test_non_solve_when_mean_iterations_are_at_most_one(iters, flag):
    out = bt.quality("t", torch.tensor(iters), torch.tensor([True, False, True]), 3.0, 2)
    assert out["non_solve_t"] is flag
    assert out["iters_t"] == sum(iters) and out["conv_frac_t"] == 2 / 3


def test_a_failing_point_records_its_error_and_the_rest_run(monkeypatch):
    def broken(s):
        raise ValueError("forced")

    monkeypatch.setitem(bt.POINTS, "distributed_50",
                        bt.dataclasses.replace(bt.POINTS["distributed_50"], run=broken))
    argv = ["--device", "cpu", "--reps", "1", "--point", "distributed_50",
            "--point", "centralized_10", "--point", "baseline"]
    rc, lines = _run(argv)
    extra = lines[-1]["extra"]
    assert rc == 1
    assert extra["distributed_50_error"] == "ValueError: forced"
    assert lines[0] == {"point": "distributed_50",
                        "distributed_50_error": "ValueError: forced",
                        "seconds_distributed_50": lines[0]["seconds_distributed_50"]}
    assert extra["incomplete"] == ["ms_50_distributed"]
    assert extra["ms_10_centralized"] > 0 and extra["baseline_per_iter_ms"] > 0
    assert not any(k.endswith("_error") for k in (*lines[1], *lines[2]))
    assert lines[-1]["value"] is None and lines[-1]["vs_baseline"] is None


@pytest.mark.parametrize("device_args", [[], ["--device", "cuda"]])
def test_without_a_card_the_bench_raises(monkeypatch, device_args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        bt.main(device_args + ["--point", "baseline"], emit=lambda line: None)


def test_list_prints_the_points_in_bench_order():
    lines = []
    assert bt.main(["--list"], emit=lines.append) == 0
    assert lines == list(bt.POINTS)
    assert lines[:4] == [f"distributed_{n}" for n in (50, 100, 250, 500)]
    assert lines[-2:] == ["trials_8x100", "mpc_bike_custom_100"]


def test_busy_time_is_the_union_of_the_device_intervals():
    assert bt.union_length([]) == 0.0
    assert bt.union_length([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (6.0, 6.5)]) == 5.0


def test_traced_loop_child_reports_its_keys(capsys):
    """The child ``device_busy`` starts, run here on the CPU: no device
    interval, so no busy time."""
    bt.traced_loop(json.dumps({"device": "cpu", "dtype": "float64", "seed": 0,
                               "horizon": 2, "n": 2, "n_steps": 1}))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device_busy_frac_mpc_100"] == 0.0 and out["traced_device_events_mpc_100"] == 0
    assert out["traced_ms_per_step_mpc_100"] > 0


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rhc_cli_runs_the_closed_loop(capsys):
    ms, res = _load("torch_bench_rhc").run(bt.Setting(device=CPU, reps=2, horizon=4),
                                           n=4, n_steps=2)
    assert len(ms) == 2 and all(t > 0 for t in ms) and len(res.steps) == 2
    assert "ms/step (sustained)" in capsys.readouterr().out


def test_warmstart_cli_prints_the_jax_scripts_keys():
    lines = []
    _load("torch_bench_warmstart").run(
        bt.Setting(device=CPU, dtype=torch.float64, horizon=4, reps=1), (4,),
        emit=lines.append)
    (rec,) = [json.loads(line) for line in lines]
    jax_keys = {"n", "backend", "cold_ms", "cold_hz", "cold_iters", "cold_J",
                "cold_conv_frac", "ws_total_ms", "ws_total_hz", "ws_coupled_iters",
                "ws_J", "ws_conv_frac"}
    assert jax_keys <= set(rec) and rec["n"] == 4 and rec["backend"] == "torch"
    assert rec["cold_ms_min"] <= rec["cold_ms"] <= rec["cold_ms_max"]
    assert not rec["cold_truncated"] and not rec["ws_truncated"]


@pytest.mark.parametrize("script,argv,args", [
    ("torch_bench_rhc", ["--device", "cpu"], ()),
    ("torch_bench_warmstart", ["--device", "cpu"], ([100, 250, 500],)),
    ("torch_bench_warmstart", ["4", "9", "--device", "cpu"], ([4, 9],)),
])
def test_clis_take_only_the_device_and_the_scales(monkeypatch, script, argv, args):
    """As thin as their JAX sources: ``--device`` (the port's convention),
    and the warm-start script's positional scales."""
    mod, calls = _load(script), []
    monkeypatch.setattr(mod, "run", lambda s, *a: calls.append((s, a)))
    mod.main(argv)
    assert calls == [(bt.Setting(device=CPU), args)]
    with pytest.raises(SystemExit):
        mod.main(argv + ["--reps", "2"])


def test_each_loop_is_divided_by_its_own_steps(monkeypatch):
    """A loop that stops early is timed over its own step count, not the
    last loop's."""
    class Res:
        def __init__(self, k):
            self.steps = [None] * k

    counts = iter([4, 2, 4, 1])  # the warm-up, then three timed loops
    monkeypatch.setattr(bt, "mpc_loop", lambda *a, **k: lambda: Res(next(counts)))
    monkeypatch.setattr(bt, "cl_problem", lambda *a, **k: (None, None, None))
    ticks = iter([0.0, 0.008, 1.0, 1.004, 2.0, 2.003])
    monkeypatch.setattr(bt, "perf_counter", lambda: next(ticks))
    ms, res, _ = bt.closed_loop_run(bt.Setting(device=CPU, reps=3), n=4, n_steps=4)
    np.testing.assert_allclose(ms, [8.0 / 2, 4.0 / 4, 3.0 / 1])
    assert len(res.steps) == 1


# What the card gave for a decomposed point and the centralized one.
CARD_COLD = {"backend_100_distributed": "cuda", "backward_100_distributed": "K1",
             "launches_100_distributed": {"K1": 15, "K2": 30, "K4": 1}}
CARD_CENTRAL = {"backend_10_centralized": "cuda", "backward_10_centralized": "K5",
                "launches_10_centralized": {"K5": 13, "K4": 14}}


@pytest.mark.parametrize("name,rec,want", [
    ("distributed_100", CARD_COLD, []),
    ("centralized_10", CARD_CENTRAL, []),
    ("baseline", {}, []),
    ("distributed_100", {**CARD_COLD, "backend_100_distributed": "torch"}, ["backend torch"]),
    ("distributed_100", {**CARD_COLD, "backward_100_distributed": "twin",
                         "launches_100_distributed": {"K2": 30, "K4": 1}},
     ["the plain backward pass ran"]),
    ("distributed_100", {**CARD_COLD, "launches_100_distributed": {"K1": 15, "K4": 1}},
     ["K2 never launched"]),
    ("centralized_10", {**CARD_CENTRAL, "backward_10_centralized": "twin",
                        "launches_10_centralized": {"K4": 14}},
     ["the plain backward pass ran", "K5 never launched"]),
])
def test_card_faults_name_a_point_that_left_its_kernels(name, rec, want):
    assert bt.card_faults(name, rec) == want


def test_expected_keys_are_the_producers_keys():
    s = bt.Setting(device=CPU)
    cold = bt.quality("100_distributed", [2, 3], [True, False], 1.0, 4)
    cold.update(bt.path_keys("100_distributed", "torch", {}))
    assert set(bt.expected_keys("distributed_100", s)) - set(cold) == {
        "ms_100_distributed", "ms_100_distributed_min", "ms_100_distributed_max",
        "riccati_block_nnz_per_s"}
    card = bt.expected_keys("mpc_100", bt.Setting(device=torch.device("cuda")))
    assert set(card) - set(bt.expected_keys("mpc_100", s)) == {
        f"{k}_mpc_100" for k in bt.BUSY}
