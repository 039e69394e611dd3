"""The attribution of the device's idle time to the program's spans
(``harness/spans.py``) on hand-made slices, and the metrics that read it
in a rehearsed traced run on the CPU."""

from __future__ import annotations

import pytest

from bench_helpers import load_run, run_cell

load_run()  # the checkout's root on the path

from perfbench.harness import spec  # noqa: E402
from perfbench.harness.spans import idle_by_span, idle_intervals, layer_idle_ms  # noqa: E402
from perfbench.harness.trace import MARK, TraceData  # noqa: E402
from perfbench.harness.window import Batch, Run, Step  # noqa: E402

IDLE_MPC = ("rhc_idle_ms.mpc", "decomp_idle_ms.mpc", "driver_idle_ms.mpc")
IDLE_TRIALS = ("driver_idle_ms.trials", "trials_idle_ms.trials")


def _slice(device, host, start=0.0, end=100.0):
    return TraceData(device=[("k", a, b) for a, b in device], host=host,
                     window_us=end - start, start_us=start, end_us=end)


def test_idle_is_the_slice_less_the_device_intervals():
    t = _slice([(-5, 10), (20, 30), (25, 40), (95, 120)], [])
    assert idle_intervals(t) == [(10, 20), (40, 95)]
    assert idle_by_span(t) == {None: 65.0}


def test_idle_goes_to_the_innermost_program_span():
    host = [(MARK, 0, 100), ("dpilqr.rhc.step", 0, 100), ("dpilqr.batched.solve", 20, 80),
            ("dpilqr.batched.read", 50, 60), ("aten::item", 52, 58),
            ("cudaStreamSynchronize", 53, 57)]
    t = _slice([(10, 15), (30, 50), (60, 70)], host)
    got = idle_by_span(t)
    # 0-10, 15-20 and 80-100 under the step; 20-30 and 70-80 under the
    # solve; 50-60 under the read (the torch op and the sync inside it are
    # not program spans).
    assert got == {"dpilqr.rhc.step": 35.0, "dpilqr.batched.solve": 20.0,
                   "dpilqr.batched.read": 10.0}


def test_idle_under_a_torch_op_goes_to_the_span_around_it():
    host = [("dpilqr.distributed.gather", 10, 40), ("aten::index", 12, 38),
            ("ProfilerStep#1", 0, 100)]
    t = _slice([(40, 100)], host)
    assert idle_by_span(t) == {None: 10.0, "dpilqr.distributed.gather": 30.0}


def test_a_gap_is_split_where_a_span_closes_and_another_opens():
    host = [("dpilqr.rhc.episode", 0, 60), ("dpilqr.rhc.advance", 10, 30),
            ("dpilqr.rhc.read", 30, 35), ("dpilqr.rhc.log_fn", 45, 55)]
    t = _slice([(0, 5), (35, 40), (70, 100)], host)
    assert idle_by_span(t) == {"dpilqr.rhc.episode": 15.0, "dpilqr.rhc.advance": 20.0,
                               "dpilqr.rhc.read": 5.0, "dpilqr.rhc.log_fn": 10.0,
                               None: 10.0}
    run = Run(kind="closed_loop", problem=None, traffic={}, trace=t)
    run.steps = [Step(ms=1.0, solve_s=0.0, K=1, iters=None, converged=None, traced=True)] * 2
    # Per traced step, less the callback.
    assert layer_idle_ms(run, "rhc", 2, exclude=("dpilqr.rhc.log_fn",)) == pytest.approx(0.02)
    assert layer_idle_ms(run, "batched", 2) is None  # no span of the layer


def test_readers_return_nothing_for_a_program_without_spans():
    t = _slice([(10, 20)], [(MARK, 0, 100), ("aten::copy_", 30, 40)])
    cell = spec.find_cell("uni100.mpc")
    run = Run(kind="closed_loop", problem=None, traffic={}, trace=t)
    run.steps = [Step(ms=1.0, solve_s=0.0, K=1, iters=None, converged=None, traced=True)]
    for name in IDLE_MPC + ("host_reads.mpc",):
        assert spec.metric_reader(cell, name).read(run) is None, name
    run = Run(kind="trial_batch", problem=None, traffic={}, trace=t)
    run.batches = [Batch(ms=1.0, trials=2, K=1, iters=None, converged=None, truncated=0,
                         traced=True)]
    for name in IDLE_TRIALS:
        assert spec.metric_reader(cell, name).read(run) is None, name


@pytest.mark.parametrize("cell,idle", [("uni100.mpc", IDLE_MPC),
                                       ("uni100.trials8", IDLE_TRIALS)])
def test_rehearsed_traced_run_counts_reads_and_has_no_idle_on_the_cpu(cell, idle):
    out = run_cell(cell, seed=2**31 + 77, seconds=1.0, trace=True)
    assert out["correct"] is True
    assert set(idle) <= set(out["missing_metrics"])
    if cell == "uni100.mpc":
        assert out["metrics"]["host_reads.mpc"]["value"] >= 1
