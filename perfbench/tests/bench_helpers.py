"""Helpers of the benchmark's tests: a cell's run through ``run.run_cell``,
where asked with the timed path's batched solve replaced or broken
underneath, or with the window's clock counting readings instead of
seconds.  Run as a script, one such run in the checkout that holds this
file, its result printed as one JSON line:

    python3 perfbench/tests/bench_helpers.py --cell <cell> --seed <n> --seconds <s>
        [--full] [--trace] [--ticks] [--fault <name> | --control]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CELLS = ("uni100.mpc", "quad64.mpc", "uni100.trials8")
# Reference dynamics of models that no shipped configuration runs, which
# the tests bring in as a later configuration would.
MODELS = BENCH / "tests" / "models"


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


class Ticks:
    """A clock that advances one second a reading.  Put in a kind's place of
    ``perf_counter``, it makes a window of ``seconds`` cover a fixed amount
    of work, the same on every run of one seed: two harnesses are then
    compared on the same solves."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _ticked(mod):
    mod.perf_counter = Ticks()
    return mod


def run_cell(cell: str, seed: int, seconds: float, rehearse: bool = True, trace: bool = False,
             root: Path = ROOT, control=None, fault: str | None = None,
             ticks: bool = False) -> dict:
    """One run of ``cell``; ``control`` (``harness.control.control()``'s
    pair) or ``fault`` (a name of ``harness.control.FAULTS``) takes the
    place of the program's batched solve for the run; with ``ticks`` the
    window's clock is a ``Ticks``."""
    run = load_run()
    from perfbench.harness import spec
    from perfbench.harness.control import installed
    from perfbench.harness.record import Patch

    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(int(trace))] + (["--rehearse"] if rehearse else [])
    patches = []
    if ticks:
        patches.append(Patch((spec, "kind_module",
                              lambda c, orig=spec.kind_module: _ticked(orig(c)))))
    if control is not None or fault is not None:
        patches.append(Patch((spec, "kind_module",
                              lambda c, orig=spec.kind_module: _Cold(orig(c)))))
        patches.append(installed(control, fault))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        return run.run_cell(run.parse_args(argv), root=root)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--full", action="store_true", help="the cell's own sizes, on the card")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--ticks", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)
    control = None
    if a.control:
        load_run()
        from perfbench.harness.control import control as make_control

        control = make_control()
    out = run_cell(a.cell, a.seed, a.seconds, rehearse=not a.full, trace=a.trace,
                   control=control, fault=a.fault, ticks=a.ticks)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
