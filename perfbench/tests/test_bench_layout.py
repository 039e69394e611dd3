"""``BENCHMARK.json`` against the benchmark's contract, the harness's
layout (every piece found by name, a cell added with new files only), its
imports, and the command's behaviour without a card."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bench_helpers import BENCH, MODELS, ROOT, load_run, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}


def test_metrics_against_the_contract():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    reports = {c: {n for n, m in e2e.items() if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
    layers = set()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        for c in m["workloads"]:
            assert m["moves"] in reports[c], (m["name"], c)
        layers.add(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        mod = (BENCH / "metrics" / f"{m['name']}.py")
        assert mod.is_file(), m["name"]
        text = mod.read_text()
        assert f'"{m["name"]}"' in text and f'"{m["unit"]}"' in text
        if "layer" in m:
            assert m["layer"] in text and f'"{m["moves"]}"' in text
    for c in cells:
        assert any(c in m["workloads"] for m in b["per_layer"])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "dpilqr_tpu"}, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "dpilqr_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    run = load_run()
    monkeypatch.setitem(sys.modules, "dpilqr_tpu_torchlike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dpilqr_tpu.parallel", sys)
    assert run.forbidden_modules() == ["dpilqr_tpu"]


def _cmd(cwd: Path, *extra, seconds: float = 1.0):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "uni100.mpc", "--seed",
         str(2**31 + 5), "--seconds", str(seconds), "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(cwd)})


def test_command_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cmd(ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_command_in_a_bare_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench")
    out = _cmd(tmp_path, "--rehearse")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_has_the_contract_keys():
    out = _cmd(ROOT, "--rehearse", seconds=4.0)  # an episode completes
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {"step_ms", "step_ms_p95", "plan_cost", "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    tail = out.stderr.strip().splitlines()[-len(line["check"]):]
    assert all(t.startswith("check ") for t in tail)


def test_a_cell_is_added_with_new_files_only(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric, each a new
    file (and entries in BENCHMARK.json), run with no existing file of the
    harness edited."""
    shutil.copytree(BENCH, tmp_path / "perfbench")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    b = bench()
    cfg = json.loads((BENCH / "configs" / "uni4d_swap_100.json").read_text())
    cfg.update(name="uni4d_swap_5", n_agents=5)
    (tmp_path / "perfbench" / "configs" / "uni4d_swap_5.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "mpc.json").read_text())
    mix["rehearse"]["check_calls"] = 2
    (tmp_path / "perfbench" / "traffic" / "mpc_short.json").write_text(json.dumps(mix))
    (tmp_path / "perfbench" / "metrics" / "steps_done.mpc.py").write_text(
        '"""Steps completed in the window."""\n\n'
        'NAME, UNIT, LAYER, MOVES = "steps_done.mpc", "steps", "RHC loop", "step_ms"\n\n\n'
        'def read(run):\n    return float(len(run.steps))\n')
    b["configs"].append({"name": "uni4d_swap_5", "source": "a test", "reduced": [],
                         "file": "perfbench/configs/uni4d_swap_5.json", "why": "a test"})
    b["workloads"].append({"name": "uni5.short", "config": "uni4d_swap_5",
                           "traffic": "mpc_short", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if "workloads" in m and "uni100.mpc" in m["workloads"]:
            m["workloads"].append("uni5.short")
    b["per_layer"].append({"name": "steps_done.mpc", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "RHC loop (parallel/rhc.py)",
                           "moves": "step_ms", "workloads": ["uni5.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = run_cell("uni5.short", seed=2**31 + 41, seconds=1.0, trace=True, root=tmp_path)
    assert out["metrics"]["steps_done.mpc"]["value"] >= 1
    assert out["correct"] is True
    for p, data in before.items():
        assert p.read_bytes() == data, p


MIXED = "mixed7.mpc"


@pytest.fixture(scope="module")
def mixed_checkout(tmp_path_factory):
    """A checkout with a mixed fleet added as new files only (and entries in
    BENCHMARK.json): a model's reference dynamics (DoubleInt4D), a scenario
    layout, and a configuration of Unicycle4D and DoubleInt4D robots beside
    an uncontrolled DoubleInt4D agent, warm-started selfishly, run as a
    closed loop.  Returns the checkout and its harness's files as they
    were before."""
    root = tmp_path_factory.mktemp("mixed")
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "dpilqr_tpu_torch").symlink_to(ROOT / "dpilqr_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    bench_dir = root / "perfbench"
    shutil.copy(MODELS / "DoubleInt4D.py", bench_dir / "reference" / "models")
    (bench_dir / "layouts").mkdir()
    shutil.copy(BENCH / "tests" / "layouts" / "crossing.py", bench_dir / "layouts")
    cfg = json.loads((BENCH / "configs" / "uni4d_swap_100.json").read_text())
    for k in ("model", "n_agents", "n_pos", "assumed", "deployment", "rehearse"):
        del cfg[k]
    cfg.update(name="mixed_7", source="a test", N=8,
               fleet=[{"model": "Unicycle4D", "count": 3}, {"model": "DoubleInt4D", "count": 3},
                      {"model": "DoubleInt4D", "count": 1, "controlled": False}],
               scenario={"layout": "crossing", "spacing": 0.6})
    cfg["rhc"].update(t_diverge=0.6, warm_start="selfish")
    (bench_dir / "configs" / "mixed_7.json").write_text(json.dumps(cfg))
    b = bench()
    b["configs"].append({"name": "mixed_7", "source": "a test", "reduced": [],
                         "file": "perfbench/configs/mixed_7.json", "why": "a test"})
    b["workloads"].append({"name": MIXED, "config": "mixed_7", "traffic": "mpc", "chips": 1,
                           "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "uni100.mpc" in m.get("workloads", ()):
            m["workloads"].append(MIXED)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root, before


def _run_in(root: Path, *extra) -> dict:
    """One rehearsed run of the mixed cell in its own process, which imports
    the harness of ``root``."""
    out = subprocess.run(
        [sys.executable, str(root / "perfbench" / "tests" / "bench_helpers.py"), "--cell",
         MIXED, "--seed", str(2**31 + 43), "--seconds", "1", *extra],
        cwd=root, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("variant", [(), ("--fault", "unchanged"), ("--fault", "half"),
                                     ("--fault", "altered"), ("--control",)],
                         ids=["sound", "unchanged", "half", "altered", "bf16_control"])
def test_a_mixed_fleet_is_added_with_new_files_only(mixed_checkout, variant):
    """The mixed fleet's cell rehearses correct, its work counted slot by
    slot in a traced run, and each planted fault and the control in bfloat16
    read not correct in it, with no file of the harness edited."""
    root, before = mixed_checkout
    out = _run_in(root, *(variant or ("--trace",)))
    assert out["check"]["lanes_judged"]["value"] > 0
    numbers = {k: v["value"] for k, v in out["check"].items()}
    assert out["correct"] is (not variant), numbers
    if not variant:
        assert out["metrics"]["mean_iters.mpc"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p


@pytest.mark.parametrize("metric", ["mean_iters.mpc", "mean_iters.trials", "conv_frac"])
def test_iteration_readers_leave_out_uncontrolled_lanes(metric):
    """An uncontrolled agent's lane is not solved (zero iterations, no flag):
    the readers of iterations and convergence average over the others."""
    load_run()  # the checkout's root on the path
    from perfbench.harness import spec
    from perfbench.harness.window import Batch, Run, Step

    mask = np.array([False, False, True])
    iters, conv = np.array([4, 6, 0]), np.array([True, True, False])
    problem = SimpleNamespace(ignore_mask=mask)
    if metric.endswith(".trials"):
        run = Run(kind="trial_batch", problem=problem, traffic={})
        run.batches = [Batch(ms=1.0, trials=2, K=2, iters=np.tile(iters, 2),
                             converged=np.tile(conv, 2), truncated=0, traced=False)]
    else:
        run = Run(kind="closed_loop", problem=problem, traffic={})
        run.steps = [Step(ms=1.0, solve_s=0.001, K=2, iters=iters, converged=conv,
                          traced=False)]
    read = spec.load_module(BENCH / "metrics" / f"{metric}.py",
                            "perfbench_metric_" + metric.replace(".", "_")).read
    assert read(run) == (100.0 if metric == "conv_frac" else 5.0)
    problem.ignore_mask = np.zeros(3, dtype=bool)
    assert read(run) == pytest.approx(200.0 / 3 if metric == "conv_frac" else 10.0 / 3)
