#!/usr/bin/env python3
"""Where a step of the wide batched Riccati kernel (K3) spends its cycles.

Builds the kernels with ``-DDPILQR_PHASE_CLOCKS`` (``csrc/riccati.cuh``: the
first thread of the first CTA sums ``clock64()`` deltas between the phase
barriers), launches ``backward_pass_batched_wide_cuda`` once at each of
``chip_smoke.py``'s float32 shapes and prints the cycles per step of each
phase.  Needs one CUDA device; run from the repository root:

    python3 scripts/riccati_phase_clocks.py
"""

import ctypes
import os
import sys

os.environ["DPILQR_NVCC_FLAGS"] = "-DDPILQR_PHASE_CLOCKS"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import dpilqr_tpu_torch as dtt  # noqa: E402
from dpilqr_tpu_torch.ops import batched as bt  # noqa: E402
from dpilqr_tpu_torch.ops import cuda_build  # noqa: E402

PHASES = ("load A, B", "1 Qx Qu AtP W1", "2 Qxx Qux Quu", "3 Gauss-Jordan",
          "4 gains", "5 QuuK KtQux", "6 value update", "7 symmetrize")


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda", 0)
    lib = cuda_build.load_library()
    lib.dpilqr_riccati_phase_clocks.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    buf = (ctypes.c_ulonglong * len(PHASES))()
    print(f"device: {torch.cuda.get_device_name(0)}; cycles per step (N = {cs.HORIZON}) "
          "of the first CTA, float32")
    g = 9.80665
    cases = [("Unicycle4D K=8 nxf 32", None)] + [
        (f"{m.name} K={K} nxf {K * m.n_x}", (m, K, us, trim)) for m, K, us, trim in (
            (dtt.QUAD_6D, 8, 0.01, [g, 0, 0]), (dtt.QUAD_12D, 8, 1e-7, [0, 0, 0, g * 63 / 2000]),
            (dtt.QUAD_6D, 16, 0.01, [g, 0, 0]))]
    for tag, case in cases:
        if case is None:
            fleet, cost, x0 = cs.unicycle_problem(cs.N_AGENTS, 0.55, torch.float32, dev)
            args = cs.sweep_inputs(fleet, cost, x0, 8, dev)[0]
        else:
            model, K, u_scale, trim = case
            fleet, cost, x0 = cs.quad_problem(model, 64, 0.7, torch.float32, dev)
            args = cs.sweep_inputs(fleet, cost, x0, K, dev, u_scale=u_scale,
                                   u_trim=np.array(trim))[0]
        lib.dpilqr_riccati_phase_clocks(buf)  # clear
        bt.backward_pass_batched_wide_cuda(*args)
        if lib.dpilqr_riccati_phase_clocks(buf) != 0:
            sys.exit("reading the phase clocks failed")
        per_step = np.array(list(buf), dtype=np.float64) / cs.HORIZON
        print(f"{tag}: total {per_step.sum():.0f}; "
              + ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, per_step)),
              flush=True)


if __name__ == "__main__":
    main()
