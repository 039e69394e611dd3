#!/usr/bin/env python3
"""The selfish warm start against the cold solve, on the PyTorch/CUDA port.

The reference ships a per-agent solo warm start (problem.py:66-91
``selfish_warmstart``); the port batches it as one singleton-graph
decomposed solve.  Does warm start + coupled solve beat the cold solve end
to end, without a worse plan (converged fraction, joint cost)?  The port's
counterpart of ``scripts/bench_warmstart.py``: one JSON line a scale, both
paths timed as ``bench_torch.py`` times a solve (median, min and max of 5
repeats after a warm-up, the device synchronized around each), float32.

    python3 scripts/torch_bench_warmstart.py [N ...] [--device cuda|cpu]
"""

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench_torch as bt  # noqa: E402


def run(s, scales=(100, 250, 500), emit=print):
    for n in scales:
        problem = bt.grid_problem(s, n)
        out = {"n": n, "backend": bt.backend_of(s)}
        # The JSON keys of scripts/bench_warmstart.py, each time with its spread.
        for time_key, pre, iters_key, solve in (
                ("cold_ms", "cold", "cold_iters", bt.cold_solve),
                ("ws_total_ms", "ws", "ws_coupled_iters", bt.warmstarted_solve)):
            ms, res, _ = bt.timed(s, lambda solve=solve: solve(s, *problem, bt.K_SLOTS))
            conv = np.asarray(res.converged.cpu(), dtype=np.float64)
            out.update({**bt.spread(time_key, ms, time_key.replace("_ms", "_hz")),
                        iters_key: int(res.iters.sum()), f"{pre}_J": float(res.J),
                        f"{pre}_conv_frac": float(conv.mean()),
                        f"{pre}_truncated": bool(res.truncated)})
        emit(json.dumps(out))
        sys.stdout.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scales", type=int, nargs="*", default=[100, 250, 500])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    run(bt.Setting(device=bt.device_named(args.device)), args.scales)


if __name__ == "__main__":
    main()
