#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA device must be present; prints its name and
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. Build: compiles the hand-written kernels in ``dpilqr_tpu_torch/csrc``
   with nvcc (timed).
3. Kernel vs plain PyTorch twin at the main path's shape (S=100
   subproblems, K=8 slots, nx_p=4, nu_p=2, N=50), float64 and float32,
   forward with 2 and 10 alphas, with and without gains; plus a mixed
   DoubleInt4D+Car3D+Bike5D batch in float64.  Times each kernel against
   its twin with CUDA events.
4. Main path: ``solve_rhc(centralized=False)`` for 100 Unicycle4D agents,
   float32, 5 MPC steps, on the kernels (launch counts reset just before)
   and again on the twins; prints ms per step, J, K, iterations and the
   converged fraction of both.
5. Float64 solve parity of the two backends at n=16, N=20.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_AGENTS, HORIZON, DT, RADIUS = 100, 50, 0.1, 0.5
MPC_STEPS = 5
# Tolerances, relative to max|twin|.
TOL = {
    torch.float64: {"Kg": 1e-9, "d": 1e-9, "X5": 1e-9, "U5": 1e-9, "J": 1e-9},
    torch.float32: {"Kg": 2e-3, "d": 2e-3, "X5": 1e-4, "U5": 1e-4, "J": 1e-4},
}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def swap_scenario(n, spacing, seed=0):
    """Constant-density start/goal sets with local crossings: adjacent grid
    columns swap positions (the closed-loop benchmark scenario)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pts = np.stack([ii, jj], -1).reshape(-1, 2)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    col = np.arange(n) % side
    partner = np.where(
        (col % 2 == 0) & (col + 1 < side),
        np.arange(n) + 1,
        np.where(col % 2 == 1, np.arange(n) - 1, np.arange(n)),
    )
    partner = np.where(partner < n, partner, np.arange(n))
    goals = pts[partner] + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, 4))
    x0[:, :2] = pts
    xf = np.zeros((n, 4))
    xf[:, :2] = goals
    return x0, xf


def unicycle_problem(n, spacing, dtype, dev):
    import dpilqr_tpu_torch as dtt

    x0, xf = swap_scenario(n, spacing)
    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, DT)
    cost = dtt.make_game_cost(
        xf, np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=RADIUS, dtype=dtype,
        device=dev,
    )
    return fleet, cost, x0


def rel_err(a, b):
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-300), float((a - b).abs().max())


def timed(fn, reps):
    """Mean ms per call over ``reps`` calls (CUDA events), after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def batch_inputs(fleet, cost, x0, U0, K, radius, dev):
    """Gathered subproblem batch of one decomposed solve step."""
    from dpilqr_tpu_torch.parallel.graph import interaction_graph
    from dpilqr_tpu_torch.parallel.subproblems import (
        gather_controls, gather_cost, gather_states, gather_subproblems,
    )

    dtype = cost.xf.dtype
    X = torch.as_tensor(x0, dtype=dtype, device=dev)[None]
    U = torch.as_tensor(U0, dtype=dtype, device=dev)
    M = interaction_graph(X, radius, n_pos=cost.n_pos)
    batch = gather_subproblems(M, K)
    sub_cost = gather_cost(cost, batch, dtype)
    branch = torch.as_tensor(fleet.branch_index_array, dtype=torch.int32, device=dev)
    return sub_cost, gather_states(X[0], batch), gather_controls(U, batch), branch[batch.member_idx]


def kernel_checks(dev, results):
    """Phase 3: each kernel against its twin at the main path's shape."""
    import dpilqr_tpu_torch as dtt
    from dpilqr_tpu_torch.ops import batched as bt

    worst = {}
    for dtype in (torch.float64, torch.float32):
        # Spacing 0.55 packs the 100-agent scenario so that subproblems
        # fill most of their 8 slots (some stay padded) and proximity pairs
        # are active, while the closed loop stays well conditioned (denser
        # packings amplify a 1e-15 gain perturbation past 1e-9).
        fleet, cost, x0 = unicycle_problem(N_AGENTS, 0.55, dtype, dev)
        rng = np.random.default_rng(0)
        U0 = rng.uniform(size=(HORIZON, N_AGENTS, 2)) * 0.01
        sub_cost, x0_s, U_s, mids = batch_inputs(fleet, cost, x0, U0, 8, RADIUS, dev)
        S = x0_s.shape[0]
        cfg = dtt.SolverConfig()
        carry = bt.init_batch_carry(fleet, cfg, sub_cost, x0_s, U_s, mids,
                                    torch.ones(S, dtype=torch.bool, device=dev), "torch")
        mu = torch.linspace(0.5, 1.5, S, dtype=dtype, device=dev)
        q = bt._quadraticize_batch(sub_cost, carry.X, carry.U)
        A, B = bt._linearize_batch(fleet, sub_cost, mids, carry.X, carry.U)
        args = (A, B, q["L_uu"], q["L_xx"], q["L_x"], q["L_u"], mu, q["p0"], q["P0"])
        Kg_t, d_t = bt.backward_pass_batched_torch(*args)
        Kg_c, d_c = bt.backward_pass_batched_cuda(*args)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        for name, a, b in (("Kg", Kg_c, Kg_t), ("d", d_c, d_t)):
            rel, ab = rel_err(a, b)
            print(f"K1 {str(dtype)[6:]} {name}: rel err {rel:.3e} (abs {ab:.3e}, tol {tol[name]:g})")
            if not rel <= tol[name]:
                fail(f"backward kernel disagrees with its twin on {name}")
            worst[("backward", dtype)] = max(worst.get(("backward", dtype), 0.0), ab)
        if dtype == torch.float32:
            results["backward_ms"] = timed(lambda: bt.backward_pass_batched_cuda(*args), 20)
            results["backward_plain_ms"] = timed(lambda: bt.backward_pass_batched_torch(*args), 3)
        for n_alpha in (2, 10):
            alphas = dtt.ops.line_search_alphas(n_alpha, dtype, dev)
            for gains in (True, False):
                Kg, d = (Kg_t, d_t) if gains else (None, None)
                fa = (fleet, sub_cost, mids, carry.X, carry.U, Kg, d, alphas)
                out_t = bt.forward_pass_batched_torch(*fa)
                out_c = bt.forward_pass_batched_cuda(*fa)
                torch.cuda.synchronize()
                for name, a, b in zip(("X5", "U5", "J"), out_c, out_t):
                    rel, ab = rel_err(a, b)
                    print(f"K2 {str(dtype)[6:]} alphas={n_alpha} gains={gains} {name}: "
                          f"rel err {rel:.3e} (abs {ab:.3e}, tol {tol[name]:g})")
                    if not rel <= tol[name]:
                        fail(f"forward kernel disagrees with its twin on {name}")
                    if gains:
                        key = ("forward", dtype)
                        worst[key] = max(worst.get(key, 0.0), ab)
                if dtype == torch.float32 and gains:
                    results[f"forward_ms_{n_alpha}"] = timed(
                        lambda: bt.forward_pass_batched_cuda(*fa), 20)
                    results[f"forward_plain_ms_{n_alpha}"] = timed(
                        lambda: bt.forward_pass_batched_torch(*fa), 3)
    results["backward_err"] = worst[("backward", torch.float32)]
    results["forward_err"] = worst[("forward", torch.float32)]

    # Mixed RK4 substeps (Bike5D takes 1, the others 5), float64.
    names = ["DoubleInt4D", "Car3D", "Bike5D"] * 4
    fleet = dtt.Fleet.from_names(names, DT)
    n, nx_p, nu_p = fleet.n_agents, fleet.nx_p, fleet.nu_p
    x4, xf4 = swap_scenario(n, 0.55)
    x0 = np.zeros((n, nx_p))
    x0[:, :2] = x4[:, :2]
    xf = np.zeros((n, nx_p))
    xf[:, :2] = xf4[:, :2]
    cost = dtt.make_game_cost(
        xf, np.tile(np.eye(nx_p), (n, 1, 1)), np.tile(np.eye(nu_p), (n, 1, 1)),
        np.tile(1e3 * np.eye(nx_p), (n, 1, 1)), radius=RADIUS,
        dtype=torch.float64, device=dev,
    )
    rng = np.random.default_rng(1)
    U0 = rng.uniform(size=(HORIZON, n, nu_p)) * 0.01 * fleet.control_mask
    sub_cost, x0_s, U_s, mids = batch_inputs(fleet, cost, x0, U0, 4, RADIUS, dev)
    S = x0_s.shape[0]
    carry = bt.init_batch_carry(fleet, dtt.SolverConfig(), sub_cost, x0_s, U_s, mids,
                                torch.ones(S, dtype=torch.bool, device=dev), "torch")
    X = carry.X
    Kg, d = bt.backward_pass_batched(fleet, sub_cost, mids, X, carry.U,
                                     torch.ones(S, dtype=torch.float64, device=dev), "torch")
    alphas = dtt.ops.line_search_alphas(10, torch.float64, dev)
    fa = (fleet, sub_cost, mids, X, carry.U, Kg, d, alphas)
    for name, a, b in zip(("X5", "U5", "J"), bt.forward_pass_batched_cuda(*fa),
                          bt.forward_pass_batched_torch(*fa)):
        rel, ab = rel_err(a, b)
        print(f"K2 float64 mixed-substeps {name}: rel err {rel:.3e} (abs {ab:.3e})")
        if not rel <= 1e-9:
            fail(f"forward kernel disagrees with its twin on the mixed batch ({name})")


def main_path(dev, backend):
    """Phase 4: the closed-loop decomposed MPC run; returns a summary."""
    import dpilqr_tpu_torch as dtt

    fleet, cost, x0 = unicycle_problem(N_AGENTS, 1.25, torch.float32, dev)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dtt.solve_rhc(
        fleet, cost, x0.astype(np.float32), HORIZON, radius=RADIUS,
        centralized=False, step_size=1, J_converge=1e-3,
        t_diverge=(MPC_STEPS - 1) * DT, config=cfg,
        rng=np.random.default_rng(0), device=dev,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = res.steps
    if len(steps) < MPC_STEPS:
        fail(f"{backend}: only {len(steps)} MPC steps ran")
    if not all(np.isfinite(s.J) for s in steps) or not np.isfinite(res.J):
        fail(f"{backend}: non-finite J")
    if any(s.k_max > s.K for s in steps):
        fail(f"{backend}: a step was truncated")
    if not np.isfinite(res.X).all():
        fail(f"{backend}: non-finite trajectory")
    iters = np.concatenate([np.asarray(s.iters) for s in steps])
    conv = np.concatenate([np.asarray(s.converged) for s in steps])
    return {
        "ms_per_step": wall / len(steps) * 1e3,
        "steps": len(steps),
        "J_final_step": steps[-1].J,
        "J_executed": res.J,
        "K": [s.K for s in steps],
        "mean_iters": float(iters.mean()),
        "converged_frac": float(conv.mean()),
    }


def solve_parity(dev):
    """Phase 5: float64 decomposed solve, kernels vs twins."""
    import dpilqr_tpu_torch as dtt

    # Spacing 1.0 keeps the solve well conditioned (at 0.75 a 1e-14
    # warm-start perturbation already moves X by 2e-8), while neighborhoods
    # of up to 4 agents still couple.
    fleet, cost, x0 = unicycle_problem(16, 1.0, torch.float64, dev)
    rng = np.random.default_rng(3)
    N = 20
    X = torch.as_tensor(x0, device=dev)[None]
    U = torch.as_tensor(rng.uniform(size=(N, 16, 2)) * 0.01, device=dev)
    out = {}
    for backend in ("cuda", "torch"):
        cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend=backend)
        out[backend] = dtt.solve_distributed(fleet, cost, X, U, RADIUS, config=cfg)
    a, b = out["cuda"], out["torch"]
    print(f"f64 parity: iters cuda {a.iters.tolist()} torch {b.iters.tolist()}")
    if not torch.equal(a.iters, b.iters) or not torch.equal(a.converged, b.converged):
        fail("float64 solve: iteration counts or converged flags differ")
    dJ = abs(float(a.J) - float(b.J)) / abs(float(b.J))
    dX = float((a.X - b.X).abs().max())
    print(f"f64 parity: J {float(a.J)!r} vs {float(b.J)!r} (rel {dJ:.3e}), "
          f"max|dX| {dX:.3e}")
    if not (dJ <= 1e-9 and dX <= 1e-8):
        fail("float64 solve: J or X differ beyond rtol 1e-9 / atol 1e-8")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the GPU path only")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi_line}", flush=True)

    from dpilqr_tpu_torch.ops import batched as bt
    from dpilqr_tpu_torch.ops import cuda_build

    _, build_s = cuda_build.build(verbose=True)
    cuda_build.load_library()
    print(f"build: {build_s:.1f} s", flush=True)

    results = {}
    kernel_checks(dev, results)
    print(f"K1 ms/launch: kernel {results['backward_ms']:.3f}, "
          f"twin {results['backward_plain_ms']:.3f}")
    for na in (2, 10):
        print(f"K2 ms/launch ({na} alphas): kernel {results[f'forward_ms_{na}']:.3f}, "
              f"twin {results[f'forward_plain_ms_{na}']:.3f}", flush=True)

    main_path(dev, "cuda")  # warm-up (library load, allocator, cuBLAS)
    bt.reset_launch_counts()
    kern = main_path(dev, "cuda")
    launches = dict(bt.launch_counts)
    if min(launches.values()) <= 0:
        fail(f"main path did not launch every kernel: {launches}")
    print("main path (kernels): " + json.dumps(kern), flush=True)
    bt.reset_launch_counts()
    twin = main_path(dev, "torch")
    if any(bt.launch_counts.values()):
        fail("the torch backend launched a kernel")
    print("main path (torch twins): " + json.dumps(twin), flush=True)

    solve_parity(dev)

    kernels = [
        {"name": "backward_pass_batched", "route": "cuda",
         "source": "dpilqr_tpu_torch/csrc/backward_batched.cu",
         "replaces": "dpilqr_tpu/ops/pallas_batched.py:396",
         "launches": launches["backward_pass_batched"],
         "max_abs_err": results["backward_err"],
         "ms": results["backward_ms"], "plain_ms": results["backward_plain_ms"]},
        {"name": "forward_pass_batched", "route": "cuda",
         "source": "dpilqr_tpu_torch/csrc/forward_batched.cu",
         "replaces": "dpilqr_tpu/ops/pallas_batched.py:540",
         "launches": launches["forward_pass_batched"],
         "max_abs_err": results["forward_err"],
         "ms": results["forward_ms_2"], "plain_ms": results["forward_plain_ms_2"]},
    ]
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
