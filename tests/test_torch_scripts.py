"""The port's user scripts (``scripts/torch_examples.py``,
``torch_analysis.py``, ``torch_experiment.py``) each run one tiny case with
``--device cpu``, in this process (each is a few seconds)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dpilqr_tpu_torch.utils.metrics import CSV_SCHEMA

torch.set_num_threads(1)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_single_unicycle(capsys):
    _load("torch_examples").main(["single_unicycle", "--device", "cpu", "--no-plot"])
    out = capsys.readouterr().out
    # The JAX script prints the same line for this example.
    assert "J = 3197.1285, converged = True" in out


def test_analysis_quick_sweep_writes_the_reference_schema(tmp_path):
    _load("torch_analysis").main(["--quick", "--device", "cpu", "--horizon", "10",
                                  "--t-diverge", "0.3", "--logdir", str(tmp_path)])
    (csv,) = tmp_path.glob("*.csv")
    lines = csv.read_text().strip().split("\n")
    assert lines[0] == CSV_SCHEMA
    assert len(lines) == 1 + 2 * (2 + 1)  # two runs of 2 steps and a last row
    assert lines[1].startswith('"DoubleIntDynamics4D",3,0,True,False,0.0,')
    (jsonl,) = tmp_path.glob("*.jsonl")
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["centralized"] for r in recs] == [True, False]
    assert all(r["device"] == "cpu" and np.isfinite(r["J"]) for r in recs)


@pytest.mark.parametrize("centralized", [False, True], ids=["decomposed", "centralized"])
def test_experiment_paces_and_simulates(tmp_path, centralized):
    from dpilqr_tpu_torch.native import host

    exp = _load("torch_experiment")
    argv = ["--device", "cpu", "--steps", "1", "--rate", "50", "--outdir", str(tmp_path)]
    exp.main(argv + (["--centralized"] if centralized else []))
    z = np.load(tmp_path / "torch_experiment_results.npz")
    assert z["X"].shape == (2, 4, 6) and z["U"].shape == (1, 4, 3)
    assert np.isfinite(z["X"]).all() and not np.array_equal(z["X"][0], z["X"][1])
    if host.available():
        # The plant stepped on the native library from the measured state.
        fleet = exp.dtt.Fleet((exp.dtt.DOUBLE_INT_6D,) * 2 + (exp.dtt.HUMAN_LIN_6D,) * 2,
                              exp.DT)
        assert exp.SimulatedVehicles(fleet, z["X"][0])._use_native
