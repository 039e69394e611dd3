"""The comparison that decides ``correct`` must fail its control and the
faults a cell can have: the reference in bfloat16 in the batched solve's
place, a solve that returns its state unchanged, half of the batch left
out, an answer altered where it is produced.  On the CPU at the
configurations' rehearsal sizes; on the card (``cuda``) the control at the
cells' own sizes, on three seeds, its readings appended as JSON lines to
the file that ``PERFBENCH_READINGS`` names, where it is set."""

from __future__ import annotations

import json
import os

import pytest
import torch

from bench_helpers import CELLS, run_cell


def _numbers(out):
    return {k: v["value"] for k, v in out["check"].items()}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_fault_is_not_correct(cell, fault):
    out = run_cell(cell, seed=2**31 + 17, seconds=1.0, fault=fault)
    assert out["check"]["lanes_judged"]["value"] > 0
    assert out["correct"] is False, _numbers(out)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_rehearsal_is_correct(cell):
    out = run_cell(cell, seed=2**31 + 23, seconds=1.0)
    assert out["correct"] is True, _numbers(out)


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_is_not_correct(cell):
    from perfbench.harness.control import control

    out = run_cell(cell, seed=2**31 + 29, seconds=1.0, control=control())
    assert out["correct"] is False, _numbers(out)


# A window long enough for the control to finish some requests of the mix
# (the reference in bfloat16 takes seconds a step) and to sample as many
# solves as a run does.
CARD_SECONDS = {"uni100.mpc": 30.0, "quad64.mpc": 30.0, "uni100.trials8": 20.0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's readings at the cell's size")
    from perfbench.harness.control import control

    readings = os.environ.get("PERFBENCH_READINGS")
    for seed in (3100000001, 3100000002, 3100000003):
        out = run_cell(cell, seed=seed, seconds=CARD_SECONDS[cell], rehearse=False,
                       control=control())
        if readings:
            with open(readings, "a") as f:
                f.write(json.dumps({"cell": cell, "seed": seed, "check": _numbers(out),
                                    "attempted": out["attempted"]}) + "\n")
        assert out["correct"] is False, _numbers(out)
