#!/usr/bin/env python3
"""Where an MPC step of the PyTorch/CUDA port spends its time, by section.

Wraps the sections of the decomposed solve (graph, gather, the batched
solve loop, the torch prep of the backward pass -- on the card none since
K1 and K3 compute their inputs, but the script also runs in a tree where
they took them from torch --, the three batched kernels' wrappers,
``select_alpha``, the stitched plan's joint-cost rollout, which on the card
is K4's wrapper ``rollout_cuda``; and where the tree has them the graph
loop's sections: ``iteration_graph``, the cached graph's lookup or making,
``IterationGraph.load``, a stage's copy and compaction into the graph's
buffers, and ``IterationGraph.step``, one iteration: its replay, or the
first iteration's launches and capture, and the read of the active count)
in wall-clock timers that synchronize the
device before and after, then drives ``chip_smoke.py``'s closed loops (100
Unicycle4D agents at auto K; 64 Quad6D agents at K=16 and at auto K), 5 MPC
steps each after a warm-up run, and prints the milliseconds per step of
every section, the torch prep's share and K4's share of the timed step.  The synchronizations
serialize host and device, so the step itself runs slower here than in
``chip_smoke.py``; the shares are what this script is for.  Sections nest:
the solve loop contains the preparation, the kernels, ``select_alpha`` and
the graph loop's sections; ``rollout`` contains ``rollout_cuda``.  A
section the tree does not have is left out.  Needs one CUDA device; run
from the repository root:

    python3 scripts/step_breakdown.py
"""

import importlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import dpilqr_tpu_torch as dtt  # noqa: E402

SECTIONS = {
    "dpilqr_tpu_torch.parallel.distributed": (
        "interaction_graph", "gather_subproblems", "gather_cost", "gather_states",
        "gather_controls", "solve_subproblems_batched", "rollout"),
    "dpilqr_tpu_torch.ops.sweeps": ("rollout_cuda",),
    "dpilqr_tpu_torch.ops.batched": (
        "init_batch_carry", "_quadraticize_batch", "_linearize_batch",
        "backward_pass_batched_cuda", "backward_pass_batched_wide_cuda",
        "forward_pass_batched_cuda", "select_alpha", "iteration_graph",
        "IterationGraph.load", "IterationGraph.step"),
}


def instrument(totals):
    for module_name, names in SECTIONS.items():
        module = importlib.import_module(module_name)
        for name in names:
            owner, attr = module, name
            if "." in name:
                owner, attr = name.split(".")
                owner = getattr(module, owner, None)
            fn = getattr(owner, attr, None)
            if fn is None:
                continue

            def timed(*args, _fn=fn, _name=name, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                ms, calls = totals.get(_name, (0.0, 0))
                totals[_name] = (ms + (time.perf_counter() - t0) * 1e3, calls + 1)
                return out

            setattr(owner, attr, timed)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    totals = {}
    instrument(totals)
    loops = {
        "main path (100 Unicycle4D, auto K)":
            (cs.unicycle_problem(cs.N_AGENTS, 1.25, torch.float32, dev), None),
        "quad6d_64 loop (64 Quad6D, K=16)":
            (cs.quad_problem(dtt.QUAD_6D, 64, 0.85, torch.float32, dev), 16),
        "quad6d_64 loop (64 Quad6D, auto K)":
            (cs.quad_problem(dtt.QUAD_6D, 64, 0.85, torch.float32, dev), None),
    }
    for tag, ((fleet, cost, x0), K) in loops.items():
        cs.rhc_run(fleet, cost, x0, "cuda", cs.MPC_STEPS, K=K)  # warm-up
        totals.clear()
        run = cs.rhc_run(fleet, cost, x0, "cuda", cs.MPC_STEPS, K=K)
        per_step = {name: {"ms_per_step": ms / run["steps"], "calls_per_step": n / run["steps"]}
                    for name, (ms, n) in totals.items()}
        def ms(name):
            return per_step.get(name, {"ms_per_step": 0.0})["ms_per_step"]

        k4 = ms("rollout_cuda")
        prep = ms("_quadraticize_batch") + ms("_linearize_batch")
        print(f"{tag}: {run['ms_per_step']:.1f} ms a step with the timers on, of which "
              f"the torch prep {prep:.3f} ms ({prep / run['ms_per_step']:.4f}), K4's "
              f"rollouts {k4:.3f} ms ({k4 / run['ms_per_step']:.4f}); "
              + json.dumps(per_step), flush=True)


if __name__ == "__main__":
    main()
