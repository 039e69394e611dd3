#!/usr/bin/env python3
"""Closed-loop RHC benchmark of the PyTorch/CUDA port: sustained ms per MPC
step at 100 agents.

Thin CLI over ``bench_torch.closed_loop_run`` (the workload of
``scripts/bench_rhc.py``, with K pinned at 8): graph build, subproblem
gather, batched solve, advance and warm-start shift, every replanning
period, timed over whole loops after a warm-up loop.

    python3 scripts/torch_bench_rhc.py [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from bench_torch import Setting, closed_loop_run, device_named  # noqa: E402


def run(s, n=100, n_steps=20, K=8, verbose=True):
    ms, res, _ = closed_loop_run(s, n=n, n_steps=n_steps, K=K)
    solve_ms = np.mean([st.solve_time for st in res.steps]) * 1e3
    if verbose:
        med = float(np.median(ms))
        print(f"steps: {len(res.steps)}")
        print(f"ms/step (sustained): {med:.2f} (min {min(ms):.2f}, max {max(ms):.2f}; "
              f"{1000 / med:.1f} Hz)")
        print(f"mean per-step solve_time: {solve_ms:.2f} ms  J: {res.J:.1f}")
    return ms, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return run(Setting(device=device_named(ap.parse_args(argv).device)))


if __name__ == "__main__":
    main()
