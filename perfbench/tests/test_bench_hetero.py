"""The mixed fleet's cell ``hetero99.mpc`` (``configs/hetero_99.json``:
DoubleInt4D, Car3D and Bike5D agents in turn) at its rehearsal size on the
CPU: it reads correct, its traced run counts the rooflines' work slot by
slot at each agent's own model, and each planted fault and the control in
bfloat16 read not correct."""

from __future__ import annotations

import numpy as np
import pytest

from bench_helpers import load_run, run_cell

load_run()  # the checkout's root on the path

from perfbench.harness import window, work  # noqa: E402
from perfbench.harness.record import Patch  # noqa: E402

CELL = "hetero99.mpc"
TRIO = {"DoubleInt4D", "Car3D", "Bike5D"}


def _numbers(out):
    return {k: v["value"] for k, v in out["check"].items()}


@pytest.fixture(scope="module")
def traced():
    """One traced rehearsal: its result and the window's ``Run``."""
    runs = []

    class Kept(window.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    with Patch((window, "Run", Kept)):
        out = run_cell(CELL, seed=2**31 + 47, seconds=1.0, trace=True)
    return out, runs[0]


def test_sound_rehearsal_is_correct(traced):
    out, _ = traced
    assert out["check"]["lanes_judged"]["value"] > 0
    assert out["correct"] is True, _numbers(out)
    assert out["metrics"]["mean_iters.mpc"]["value"] > 0


@pytest.mark.parametrize("role", ["backward", "forward"])
def test_traced_work_is_counted_at_each_slots_model(traced, role):
    """The rooflines' work: the traced slice's subproblems mix the three
    models, and counting every slot at any one of them gives other work."""
    _, run = traced
    p = run.problem
    assert set(p.models) == TRIO
    seen = set()
    for K, _, rows in run.trace.solves:
        for s, row in enumerate(np.asarray(rows)):
            others = np.flatnonzero(row)
            seen |= set(p.models[[s % p.n] + others[others != s % p.n][:K - 1].tolist()])
    assert seen == TRIO
    mixed = work.needed_work(run, role)
    assert all(x > 0 for x in mixed)
    models = p.models
    try:
        for m in sorted(TRIO):
            p.models = np.full_like(models, m)
            assert work.needed_work(run, role) != mixed, m
    finally:
        p.models = models


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(fault):
    out = run_cell(CELL, seed=2**31 + 17, seconds=1.0, fault=fault)
    assert out["check"]["lanes_judged"]["value"] > 0
    assert out["correct"] is False, _numbers(out)


def test_bf16_control_is_not_correct():
    from perfbench.harness.control import control

    out = run_cell(CELL, seed=2**31 + 29, seconds=1.0, control=control())
    assert out["correct"] is False, _numbers(out)
