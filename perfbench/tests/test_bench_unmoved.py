"""The three cells read as they did before the harness took mixed fleets:
each cell's rehearsal on one seed, its window's clock a ``Ticks`` so that
it covers the same solves on every run, gives the numbers compared and the
plan cost, and the traced run the program's counters, to the bit, as the
harness before that change gave them (read on the CPU, torch 2.13)."""

from __future__ import annotations

import pytest

from bench_helpers import run_cell

SEED, TICKS = 2**31 + 63, 20

BEFORE = {
    ("uni100.mpc", False): (
        {"graph_miss": 0.0, "copy_miss": 0.0, "roll_gap": 7.095380416441702e-07,
         "cost_gap": 9.750861598295557e-08, "joint_gap": 4.958592314099913e-07,
         "solve_short": 1.3745202117218698e-07, "flag_miss": 0.0, "lanes_judged": 24},
        {"plan_cost": 6465.341301017686}),
    ("uni100.mpc", True): (
        {"graph_miss": 0.0, "copy_miss": 0.0, "roll_gap": 7.095380416441702e-07,
         "cost_gap": 9.750861598295557e-08, "joint_gap": 4.958592314099913e-07,
         "solve_short": 1.3745202117218698e-07, "flag_miss": 0.0, "lanes_judged": 24},
        {"mean_iters.mpc": 6.966666666666667, "conv_frac": 91.11111111111111,
         "host_reads.mpc": 9.666666666666666}),
    ("quad64.mpc", False): (
        {"graph_miss": 0.0, "copy_miss": 0.0, "roll_gap": 3.151828294757987e-07,
         "cost_gap": 1.0479681892283511e-07, "joint_gap": 1.4401864431640304e-07,
         "solve_short": 0.004315230143739271, "flag_miss": 0.0, "lanes_judged": 32},
        {"plan_cost": 8713.52274603794}),
    ("quad64.mpc", True): (
        {"graph_miss": 0.0, "copy_miss": 0.0, "roll_gap": 3.151828294757987e-07,
         "cost_gap": 1.0479681892283511e-07, "joint_gap": 1.4401864431640304e-07,
         "solve_short": 0.004315230143739271, "flag_miss": 0.0, "lanes_judged": 32},
        {"mean_iters.mpc": 7.566666666666666, "conv_frac": 64.16666666666667,
         "host_reads.mpc": 12.333333333333334}),
    ("uni100.trials8", False): (
        {"graph_miss": 0.0, "copy_miss": 0.0, "roll_gap": 2.958835213179952e-07,
         "cost_gap": 8.383277117046937e-08, "joint_gap": 1.5892719251471946e-07,
         "solve_short": 4.090908042182329e-08, "flag_miss": 0.0, "lanes_judged": 24},
        {"plan_cost": 1097.0068668437746}),
    ("uni100.trials8", True): (
        {"graph_miss": 0.0, "copy_miss": 0.0, "roll_gap": 3.94032636002053e-07,
         "cost_gap": 8.383277117046937e-08, "joint_gap": 1.5892719251471946e-07,
         "solve_short": 3.2932836856364565e-08, "flag_miss": 0.0, "lanes_judged": 24},
        {"mean_iters.trials": 11.287878787878787, "conv_frac": 87.87878787878788}),
}


@pytest.mark.parametrize("cell,trace", sorted(BEFORE))
def test_rehearsal_reads_as_before(cell, trace):
    check, metrics = BEFORE[cell, trace]
    out = run_cell(cell, SEED, TICKS, trace=trace, ticks=True)
    assert {k: v["value"] for k, v in out["check"].items()} == check
    assert {k: out["metrics"][k]["value"] for k in metrics} == metrics
    assert out["correct"] is True
