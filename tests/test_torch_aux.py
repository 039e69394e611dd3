"""The port's host utilities: the reference CSV schema and JSON-lines sink
(``utils/metrics.py``), the Riccati block-nnz counter, the fixed-rate loop
(``utils/rate.py``), the plots (``utils/viz.py``) and the per-step dumps
(``utils/checkpoint.py`` ``StepDumper``), against the JAX package's copies
where they compute or write something."""

import json
import time

import numpy as np
import pytest
import torch

from dpilqr_tpu.utils import metrics as jmetrics
from dpilqr_tpu.utils.checkpoint import StepDumper as JaxStepDumper
import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.utils import metrics, viz
from dpilqr_tpu_torch.utils.checkpoint import StepDumper
from dpilqr_tpu_torch.utils.metrics import (
    CSV_SCHEMA,
    JsonlWriter,
    csv_row,
    riccati_block_nnz,
    setup_csv_logger,
)

ROW = ("UnicycleDynamics4D", 3, 0, True, False, 0.1, 42.0, 50, 0.1, True,
       [0, 1, 2], [0.01], [[0, 1, 2]], [1.0, 2.0, 3.0])


def test_csv_schema_parity(tmp_path):
    """The CSV log matches the reference's analysis schema verbatim
    (reference analysis.py:120-123), row for row the JAX package's."""
    path = tmp_path / "log.csv"
    logger = setup_csv_logger(path)
    logger.info(csv_row(*ROW))
    lines = path.read_text().strip().split("\n")
    assert CSV_SCHEMA == jmetrics.CSV_SCHEMA
    assert lines[0] == (
        "dynamics,n_agents,trial,centralized,last,t,J,horizon,dt,converged,"
        "ids,times,subgraphs,dist_left"
    )
    assert lines[1] == jmetrics.csv_row(*ROW)


def test_csv_row_takes_tensors():
    """Tensors and numpy values print as the Python numbers and lists the
    JAX package's row holds."""
    row = list(ROW)
    row[5], row[6] = torch.tensor(0.1, dtype=torch.float64), np.float64(42.0)
    row[10], row[13] = torch.arange(3), np.array([1.0, 2.0, 3.0])
    assert csv_row(*row) == jmetrics.csv_row(*ROW)


def test_jsonl_writer(tmp_path):
    w = JsonlWriter(tmp_path / "sub" / "m.jsonl")
    w.write({"J": torch.tensor(1.5, dtype=torch.float64), "iters": torch.tensor([1, 2]),
             "conv": np.array([True, False]), "n": 3})
    w.write({"mode": "distributed", "sizes": (np.int64(2), 3), "t": {"solve": np.float32(0.5)}})
    recs = [json.loads(line) for line in (tmp_path / "sub" / "m.jsonl").read_text().splitlines()]
    assert recs[0] == {"J": 1.5, "iters": [1, 2], "conv": [True, False], "n": 3}
    assert recs[1] == {"mode": "distributed", "sizes": [2, 3], "t": {"solve": 0.5}}


@pytest.mark.parametrize("shape", [(1, 4, 2, 10), (100, 4, 2, 50), (8, 12, 4, 20)])
def test_riccati_block_nnz_equals_jax(shape):
    assert riccati_block_nnz(*shape) == jmetrics.riccati_block_nnz(*shape)


def test_rate_paces_and_counts_misses():
    """Drift-free rate pacing (reference timer_sleep.py / sleepForRate):
    absolute deadlines, overruns counted, no catch-up bursting."""
    r = dtt.Rate(100.0)  # 10 ms period
    t0 = time.monotonic()
    for _ in range(5):
        r.sleep()
    elapsed = time.monotonic() - t0
    # 5 ticks at 10 ms, first returns immediately: ~40 ms lower bound.
    assert elapsed >= 0.035
    assert r.ticks == 5 and r.missed == 0

    # A slow iteration (3 periods) registers exactly one miss and the next
    # deadline lands in the future (no burst of immediate returns).
    time.sleep(0.03)
    slack = r.sleep()
    assert slack < 0 and r.missed == 1
    assert r.remaining() > 0
    r.reset()
    assert r.ticks == 0 and r.remaining() == pytest.approx(0.01)

    with pytest.raises(ValueError):
        dtt.Rate(0.0)


def test_viz_smoke_under_agg(tmp_path):
    """Every plot draws from numpy and from tensors under the Agg backend."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    T, n = 6, 3
    X = np.zeros((T, n, 4))
    X[:, :, 0] = np.linspace(0, 1, T)[:, None] + np.arange(n)
    X[:, :, 1] = np.linspace(1, 0, T)[:, None]
    xf = X[-1] + 0.1
    try:
        assert viz.plot_solve(torch.as_tensor(X), torch.tensor(3.0), xf) is not None
        plt.figure()
        ax = viz.plot_pairwise_distances(torch.as_tensor(X), 0.5)
        (line, *_) = ax.get_lines()
        d = dtt.pairwise_distances(torch.as_tensor(X)).numpy()
        np.testing.assert_array_equal(line.get_ydata(), d[:, 0])
        plt.figure()
        viz.eyeball_scenario(X[0], xf)
        pytest.importorskip("networkx")
        plt.figure()
        viz.plot_interaction_graph({0: [0, 1], 1: [0, 1], 2: [2]})
    finally:
        plt.close("all")


def test_metrics_and_viz_import_no_plotting_library():
    import sys

    assert metrics.__name__ in sys.modules and viz.__name__ in sys.modules
    src = open(viz.__file__).read()
    assert "\nimport matplotlib" not in src and "\nimport networkx" not in src


def test_step_dumper(tmp_path):
    """The JAX package's test (tests/test_aux.py::test_step_dumper), with
    tensors in place of arrays."""
    d = StepDumper(tmp_path / "dumps")
    d.dump(torch.ones((3, 2, 4)), torch.zeros((2, 2, 2)), torch.tensor(1.25), {0: [0, 1]})
    d.dump(np.ones((3, 2, 4)), np.zeros((2, 2, 2)), 0.5)
    files = sorted((tmp_path / "dumps").glob("*.npz"))
    assert len(files) == 2
    z = np.load(files[0])
    assert float(z["J"]) == 1.25


def test_step_dumper_writes_the_jax_layout(tmp_path):
    """A step the port dumps and the same step the JAX package's
    ``StepDumper`` dumps from the same arrays load to equal arrays."""
    rng = np.random.default_rng(3)
    X, U = rng.normal(size=(6, 3, 4)), rng.normal(size=(5, 3, 2))
    graph = {0: [0, 2], 1: [1], 2: [0, 2]}
    ours, theirs = StepDumper(tmp_path / "port"), JaxStepDumper(tmp_path / "jax")
    for i in range(2):
        ours.dump(torch.as_tensor(X + i), torch.as_tensor(U), torch.tensor(float(i) + 0.5), graph)
        theirs.dump(X + i, U, float(i) + 0.5, graph)
    for name in ("step_00000.npz", "step_00001.npz"):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert sorted(a.files) == sorted(b.files) == ["J", "U", "X", "graph"]
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
