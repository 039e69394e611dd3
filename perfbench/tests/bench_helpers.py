"""Helpers of the benchmark's tests: a cell's run through ``run.run_cell``,
where asked with the timed path's batched solve replaced or broken
underneath."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CELLS = ("uni100.mpc", "quad64.mpc", "uni100.trials8")


def load_run():
    """``perfbench/run.py`` as a module (its folder holds no package)."""
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import run

    return run


class _Cold:
    """A kind's module whose generators skip their warm-up: a stand-in for
    the solve builds nothing to warm, and the control in bfloat16 takes
    seconds a step."""

    def __init__(self, mod):
        self.mod = mod

    def make(self, *a, **kw):
        kind = self.mod.make(*a, **kw)
        kind.warm_up = lambda: None
        return kind


def run_cell(cell: str, seed: int, seconds: float, rehearse: bool = True, trace: bool = False,
             root: Path = ROOT, control=None, fault: str | None = None) -> dict:
    """One run of ``cell``; ``control`` (``harness.control.control()``'s
    pair) or ``fault`` (a name of ``harness.control.FAULTS``) takes the
    place of the program's batched solve for the run."""
    run = load_run()
    from perfbench.harness import spec
    from perfbench.harness.control import installed
    from perfbench.harness.record import Patch

    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(int(trace))] + (["--rehearse"] if rehearse else [])
    if control is None and fault is None:
        return run.run_cell(run.parse_args(argv), root=root)
    cold = Patch((spec, "kind_module", lambda c, orig=spec.kind_module: _Cold(orig(c))))
    with cold, installed(control, fault):
        return run.run_cell(run.parse_args(argv), root=root)
