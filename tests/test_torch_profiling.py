"""The port's profiling helpers (dpilqr_tpu_torch.utils.profiling) on the
CPU: ``trace`` writing a chrome trace of a small solve, ``timed_solve`` and
``hard_sync`` without a card.  ``cuda_min_ms`` times with CUDA events and is
held under the ``cuda`` marker; ``span`` has its own tests
(``test_torch_spans.py``).
"""

import json

import numpy as np
import pytest
import torch

import dpilqr_tpu_torch as dtt
from dpilqr_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_trace_writes_a_chrome_trace(tmp_path):
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, 2, 0.1)
    cost = dtt.make_game_cost(
        np.ones((2, 4)), np.tile(np.eye(4), (2, 1, 1)), np.tile(np.eye(2), (2, 1, 1)),
        np.tile(np.eye(4), (2, 1, 1)), radius=0.5, device="cpu")
    logdir = tmp_path / "traces" / "run"
    with profiling.trace(str(logdir)) as prof:
        res = dtt.ilqr_solve(fleet, cost, torch.zeros((2, 4), dtype=torch.float64),
                             N=4, config=dtt.SolverConfig(n_lqr_iter=1))
    assert int(res.iters) == 1
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert len(events) > 0
    assert len(prof.key_averages()) > 0


def test_timed_solve_and_hard_sync():
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    x = torch.ones(3)
    s = profiling.timed_solve(fn, x, reps=4)
    assert len(calls) == 5 and s >= 0.0  # one warm-up, then the timed calls
    assert profiling.hard_sync() is None  # nothing to wait for without a card
    with pytest.raises(ValueError):
        profiling.cuda_min_ms(lambda: None, k=0)


@pytest.mark.cuda
def test_cuda_min_ms_times_device_work():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.ones((2048, 2048), device="cuda")
    ms = profiling.cuda_min_ms(lambda: a @ a, reps=2, k=5)
    assert 0.0 < ms < 1e3
