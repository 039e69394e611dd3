#!/usr/bin/env python3
"""Where a step of a Riccati kernel (K1 narrow, K3 wide, K5 sweep) spends its cycles.

Builds the kernels with ``-DDPILQR_PHASE_CLOCKS`` (``csrc/riccati.cuh``: the
first thread of the first CTA sums ``clock64()`` deltas between the phase
barriers), launches the kernel once at each shape and prints the cycles per
step of each phase, with the launch's milliseconds beside them.  Needs one
CUDA device; run from the repository root:

    python3 scripts/riccati_phase_clocks.py                  # K3, the wide shapes
                                                             # (Quad6D K=32 at S=16, 64 too)
    python3 scripts/riccati_phase_clocks.py --kernel narrow  # K1: S=100 at K=8, 4, 2, 1,
                                                             # and two run-time-width fleets
    python3 scripts/riccati_phase_clocks.py --kernel sweep   # K5: chip_smoke.py's fleets

``--threads N`` builds K1 (or K5) with N threads a CTA
(``-DDPILQR_NARROW_THREADS``, ``-DDPILQR_SWEEP_THREADS``; 256 and 512 ship).
All three kernels compute each step's inputs (csrc/computed_inputs.cuh),
the next step's on the warps the elimination leaves idle.  K1's
elimination (one warp) stores the gains itself, so its phase 4 reads as the
wait at the barrier that follows: the part of the next step's input
computation that the elimination does not hide; so does K5's at 10
Unicycle4D.  Where K3's elimination is in place (past 160 tableau
columns) the prep runs after it, inside phase 3.  A launch whose plan puts
a subproblem on a cluster of CTAs (the cluster tier, Quad6D K=32 in
float32, and the hetero_99 fleet's K=32) reads the clocks of rank 0 of the
first cluster, the rank that runs the elimination's pivot chain: phase 3
splits into 3a, the chain over Q_uu's own columns (with the other ranks'
share of the next step's prep beside it), and 3b, the right-hand columns'
pass on every rank.  A build from before that split has one phase 3.
"""

import argparse
import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Clock slots in the order a step runs them; slot 8 (3b) exists only in a
# build that splits the cluster tier's elimination.
PHASES = ("0 step top", "1 Qx Qu AtP W1", "2 Qxx Qux Quu", "3 Gauss-Jordan / 3a pivot chain",
          "4 gains", "5 QuuK KtQux", "6 value update", "7 symmetrize",
          "3b right-hand pass")
ORDER = (0, 1, 2, 3, 8, 4, 5, 6, 7)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("wide", "narrow", "sweep"), default="wide")
    parser.add_argument("--threads", type=int, default=None)
    opts = parser.parse_args()
    flags = "-DDPILQR_PHASE_CLOCKS"
    if opts.threads:
        macro = "SWEEP" if opts.kernel == "sweep" else "NARROW"
        flags += f" -DDPILQR_{macro}_THREADS={opts.threads}"
    os.environ["DPILQR_NVCC_FLAGS"] = flags  # read when cuda_build is imported

    import numpy as np
    import torch

    import chip_smoke as cs
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt
    from dpilqr_tpu_torch.ops import cuda_build, sweeps

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda", 0)
    lib = cuda_build.load_library()
    narrow = opts.kernel == "narrow"
    read = {"narrow": lib.dpilqr_riccati_phase_clocks_narrow,
            "wide": lib.dpilqr_riccati_phase_clocks,
            "sweep": lib.dpilqr_riccati_phase_clocks_sweep}[opts.kernel]
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    launch = bt.backward_pass_batched_cuda if narrow else bt.backward_pass_batched_wide_cuda
    buf = (ctypes.c_ulonglong * len(PHASES))()  # a build with 8 slots leaves the 9th 0
    print(f"device: {torch.cuda.get_device_name(0)}; {opts.kernel} kernel"
          + (f", {opts.threads} threads" if opts.threads else "")
          + f"; cycles per step (N = {cs.HORIZON}) of the first CTA, float32")
    if opts.kernel == "sweep":
        mu = torch.tensor(1.0, device=dev)
        problems = cs.k5_problems(torch.float32, dev)
        for name in ("10 Unicycle4D", "9 models", "16 Quad6D"):
            fleet, cost, X, U = problems[name]
            args = (fleet, cost, X, U, mu)
            ms = cs.timed(lambda: sweeps.backward_pass_cuda(*args), 20)
            report(read, buf, lambda: sweeps.backward_pass_cuda(*args),
                   f"K5 {name}", ms, cs.HORIZON)
        return
    g = 9.80665

    def unicycles(K):
        fleet, cost, x0 = cs.unicycle_problem(cs.N_AGENTS, 0.55, torch.float32, dev)
        return cs.sweep_inputs(fleet, cost, x0, K, dev)[0]

    def quads(model, K, u_scale, trim):
        fleet, cost, x0 = cs.quad_problem(model, 64, 0.7, torch.float32, dev)
        return cs.sweep_inputs(fleet, cost, x0, K, dev, u_scale=u_scale,
                               u_trim=np.array(trim))[0]

    def named(names, K):
        # Slots past 4 states and 2 controls: the run-time widths' path.
        fleet = dtt.Fleet.from_names(names, cs.DT)
        x0, xf = cs.swap_scenario(fleet.n_agents, 0.55)
        cost, x0 = cs.problem(fleet, x0, xf, torch.float32, dev)
        return cs.sweep_inputs(fleet, cost, x0, K, dev, seed=1)[0]

    def hetero99(K):
        # The hetero_99 configuration's fleet: 99 agents of three models in
        # turn, swapping with a neighbour at 0.75.
        fleet = dtt.Fleet.from_names(["DoubleInt4D", "Car3D", "Bike5D"] * 33, cs.DT)
        x0, xf = cs.swap_scenario(fleet.n_agents, 0.75)
        cost, x0 = cs.problem(fleet, x0, xf, torch.float32, dev)
        return cs.sweep_inputs(fleet, cost, x0, K, dev, seed=1)[0]

    if narrow:
        cases = [(f"Unicycle4D K={K} nxf {4 * K}", lambda K=K: unicycles(K))
                 for K in (8, 4, 2, 1)] + [
            ("DoubleInt4D+Car3D+Bike5D K=4 nxf 20",
             lambda: named(["DoubleInt4D", "Car3D", "Bike5D"] * 4, 4)),
            ("Bike5D K=6 nxf 30", lambda: named(["Bike5D"] * cs.N_AGENTS, 6))]
    else:
        cases = [("Unicycle4D K=8 nxf 32", lambda: unicycles(8))] + [
            (f"{m.name} K={K} nxf {K * m.n_x}", lambda c=(m, K, us, trim): quads(*c))
            for m, K, us, trim in (
                (dtt.QUAD_6D, 8, 0.01, [g, 0, 0]),
                (dtt.QUAD_12D, 8, 1e-7, [0, 0, 0, g * 63 / 2000]),
                (dtt.QUAD_6D, 16, 0.01, [g, 0, 0]))]
        # nxf 192: the quad6d_64 loop's widest steps, at the smoke's S=16
        # (every fourth subproblem) and at the whole batch's S=64.
        cases += [("Quad6D K=32 nxf 192", lambda: cs.cut_args(
                      quads(dtt.QUAD_6D, 32, 0.01, [g, 0, 0]), slice(None, None, 4))),
                  ("Quad6D K=32 nxf 192", lambda: quads(dtt.QUAD_6D, 32, 0.01, [g, 0, 0]))]
        # nxf 160: the hetero99 loop's widest steps, every third subproblem
        # and the whole batch.
        cases += [("hetero_99 K=32 nxf 160",
                   lambda: cs.cut_args(hetero99(32), slice(None, None, 3))),
                  ("hetero_99 K=32 nxf 160", lambda: hetero99(32))]
    for tag, make in cases:
        args = make()
        ms = cs.timed(lambda: launch(*args), 20)
        if not narrow:  # K3's placement: its tier and the CTAs of a subproblem
            X, U = args[3], args[4]
            plan = cuda_build.riccati_plan(X.shape[2], X.shape[3], U.shape[3],
                                           X.element_size(), cuda_build.cluster_max())
            tag += f" (tier {plan.tier}, {plan.cluster} CTA{'s' if plan.cluster > 1 else ''})"
        report(read, buf, lambda: launch(*args), f"{tag} S={cs.batch_width(args)}", ms,
               cs.HORIZON)


def report(read, buf, run, tag, ms, N):
    """One launch of ``run`` between two reads of the clocks: its cycles per
    step by phase."""
    import numpy as np

    read(buf)  # clear
    run()
    if read(buf) != 0:
        sys.exit("reading the phase clocks failed")
    per_step = np.array(list(buf), dtype=np.float64) / N
    print(f"{tag}: {ms:.4f} ms a launch (clocks on); total {per_step.sum():.0f}; "
          + ", ".join(f"{PHASES[i]} {per_step[i]:.0f}" for i in ORDER), flush=True)


if __name__ == "__main__":
    main()
