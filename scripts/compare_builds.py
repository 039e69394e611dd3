#!/usr/bin/env python3
"""Compare two trees of the PyTorch/CUDA port on one card, inside one call.

Run it from the root of each tree in turns (parent, change, change, parent:
two calls may land on two hosts, and the loops' step times are host-bound).
It needs one CUDA device and only ``chip_smoke.py`` and the package of the
tree it runs in, so it also runs in an older tree it is copied into:

    python3 scripts/compare_builds.py times TAG
    python3 scripts/compare_builds.py bits OUT.pt [OTHER.pt]

``times`` prints, each line starting with TAG: the plain rollout on K4
(``sweeps.rollout_cuda``) beside the torch loop ``_rollout_batched_cost`` at
100 Unicycle4D, 64 Quad6D and 500 Unicycle4D agents; then ms per MPC step,
mean iterations, converged fraction and J of the smoke's loops (main path
twice, once under ``t_kill`` = 0.1 s, the quad6d_64 loop at K=16 twice),
``ilqr_solve`` twice and the centralized MPC step.

``bits`` saves the outputs of the three backward kernels (K1 and K3 on the
same narrow batches, K3 at Quad6D K=16, K5 at 10 agents) and of the two
forward ones at the smoke's phase 3a and 3c shapes (K2 at 100 Unicycle4D,
K=8, 2 and 10 alphas, with and without gains; K4 with gains at 10 agents
over 10 alphas and without at 100), float64 and float32, to OUT.pt; given
OTHER.pt from another tree it says for every output whether the two builds
agree bit for bit, and whether K1 agrees with K3.
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import dpilqr_tpu_torch as dtt  # noqa: E402
from dpilqr_tpu_torch.ops import batched as bt  # noqa: E402
from dpilqr_tpu_torch.ops import cuda_build, ilqr, sweeps  # noqa: E402

G = 9.80665


def times(tag, dev):
    for name, make in (
            ("100 Unicycle4D", lambda: cs.unicycle_problem(100, 1.25, torch.float32, dev)),
            ("64 Quad6D", lambda: cs.quad_problem(dtt.QUAD_6D, 64, 0.85, torch.float32, dev)),
            ("500 Unicycle4D", lambda: cs.unicycle_problem(500, 1.25, torch.float32, dev))):
        fleet, cost, x0 = make()
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
        U = np.random.default_rng(0).uniform(size=(cs.HORIZON, fleet.n_agents, fleet.nu_p))
        U = torch.as_tensor(U * 0.01 * fleet.control_mask, dtype=torch.float32, device=dev)
        if "Quad" in name:
            U[..., 0] += G
        J_k = float(sweeps.rollout_cuda(fleet, cost, x0, U)[1])
        J_t = float(ilqr._rollout_batched_cost(fleet.step, cost, x0, U)[1])
        ms_k = cs.timed(lambda: sweeps.rollout_cuda(fleet, cost, x0, U), 20)
        ms_t = cs.timed(lambda: ilqr._rollout_batched_cost(fleet.step, cost, x0, U), 3)
        print(f"{tag} rollout {name}: K4 {ms_k:.4f} ms (J {J_k!r}), torch loop "
              f"{ms_t:.2f} ms (J {J_t!r})", flush=True)

    def loop(label, fleet, cost, x0, runs, **kw):
        cs.rhc_run(fleet, cost, x0, "cuda", cs.MPC_STEPS, **kw)  # warm-up
        for _ in range(runs):
            r = cs.rhc_run(fleet, cost, x0, "cuda", cs.MPC_STEPS, **kw)
            print(f"{tag} {label}: {r['ms_per_step']:.1f} ms/step, iterations "
                  f"{r['mean_iters']}, converged {r['converged_frac']}, J "
                  f"{r['J_final_step']!r} / executed {r['J_executed']!r}"
                  + (f", largest solve {r['max_solve_ms']:.1f} ms, at the deadline "
                     f"{r['steps_at_deadline_frac']}" if "t_kill" in kw else ""),
                  flush=True)

    fleet, cost, x0 = cs.unicycle_problem(cs.N_AGENTS, 1.25, torch.float32, dev)
    loop("main path", fleet, cost, x0, 2)
    loop("main path under t_kill", fleet, cost, x0, 1, t_kill=cs.DT)
    fleet, cost, x0 = cs.quad_problem(dtt.QUAD_6D, 64, 0.85, torch.float32, dev)
    loop("quad6d_64 K=16", fleet, cost, x0, 2, K=16)
    fleet, cost, x0 = cs.centralized_inputs(torch.float32, dev)
    x0_t = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    solve = dtt.make_solver(fleet, cs.HORIZON, dtt.SolverConfig(
        n_lqr_iter=15, tol=1e-9, sweep_backend="cuda"))
    U0 = torch.zeros((cs.HORIZON, 10, 2), dtype=torch.float32, device=dev)
    solve(cost, x0_t, U0)  # warm-up
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(cost, x0_t, U0)
        torch.cuda.synchronize()
        print(f"{tag} ilqr_solve: {(time.perf_counter() - t0) * 1e3:.1f} ms, iterations "
              f"{int(res.iters)}, J {float(res.J)!r}", flush=True)
    loop("centralized MPC", fleet, cost, x0, 1, centralized=True)


def bits(out_path, other_path, dev):
    out = {}
    for names, K in ((["Unicycle4D"], 8), (["Unicycle4D"], 4), (["Unicycle4D"], 1),
                     (["Car3D"], 5), (["Bike5D"], 6), (["Quad6D"], 5)):
        for dtype in (torch.float64, torch.float32):
            fleet = dtt.Fleet.from_names(names * 12, cs.DT)
            x4, xf4 = cs.swap_scenario(fleet.n_agents, 0.55)
            cost, x0 = cs.problem(fleet, x4, xf4, dtype, dev)
            args = cs.sweep_inputs(fleet, cost, x0, K, dev, seed=1)[0]
            key = f"{names[0]} K={K} {str(dtype)[6:]}"
            out[f"K1 {key}"] = [t.cpu() for t in bt.backward_pass_batched_cuda(*args)]
            out[f"K3 {key}"] = [t.cpu() for t in bt.backward_pass_batched_wide_cuda(*args)]
    for dtype in (torch.float64, torch.float32):
        fleet, cost, x0 = cs.quad_problem(dtt.QUAD_6D, 64, 0.7, dtype, dev)
        args = cs.sweep_inputs(fleet, cost, x0, 16, dev, u_scale=0.01,
                               u_trim=np.array([G, 0, 0]))[0]
        out[f"K3 Quad6D K=16 {str(dtype)[6:]}"] = [
            t.cpu() for t in bt.backward_pass_batched_wide_cuda(*args)]
        fleet, cost, x0 = cs.centralized_inputs(dtype, dev)
        x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
        U0 = torch.as_tensor(np.random.default_rng(2).uniform(size=(cs.HORIZON, 10, 2)) * 0.1,
                             dtype=dtype, device=dev)
        X = ilqr._rollout_fn(fleet.step, cost, x0, U0)[0]
        mu = torch.tensor(1.0, dtype=dtype, device=dev)
        out[f"K5 {str(dtype)[6:]}"] = [
            t.cpu() for t in sweeps.backward_pass_cuda(fleet, cost, X, U0, mu)]
        K, d = ilqr._backward_pass(fleet.linearize, cost, X, U0, mu)
        alphas = dtt.ops.line_search_alphas(10, dtype, dev)
        out[f"K4 10 alphas {str(dtype)[6:]}"] = [
            t.cpu() for t in sweeps.forward_pass_cuda(fleet, cost, X, U0, K, d, alphas)]
        fleet, cost, x0 = cs.unicycle_problem(cs.N_AGENTS, 0.55, dtype, dev)
        args, sub_cost, mids, carry = cs.sweep_inputs(fleet, cost, x0, 8, dev)
        Kg, d = bt.backward_pass_batched_torch(*args)
        for n_alpha in (2, 10):
            alphas = dtt.ops.line_search_alphas(n_alpha, dtype, dev)
            for gains in (True, False):
                out[f"K2 {n_alpha} alphas gains={gains} {str(dtype)[6:]}"] = [
                    t.cpu() for t in bt.forward_pass_batched_cuda(
                        fleet, sub_cost, mids, carry.X, carry.U, Kg if gains else None,
                        d if gains else None, alphas)]
        U = torch.as_tensor(np.random.default_rng(5).uniform(size=(cs.HORIZON, cs.N_AGENTS, 2))
                            * 0.01, dtype=dtype, device=dev)
        out[f"K4 rollout 100 {str(dtype)[6:]}"] = [t.cpu() for t in sweeps.rollout_cuda(
            fleet, cost, torch.as_tensor(x0, dtype=dtype, device=dev), U)]
    torch.save(out, out_path)
    for key, val in out.items():
        if key.startswith("K1"):
            same = all(torch.equal(a, b) for a, b in zip(val, out["K3" + key[2:]]))
            print(f"{key}: K1 and K3 agree bit for bit: {same}")
    if other_path:
        other = torch.load(other_path)
        for key, val in out.items():
            same = all(torch.equal(a, b) for a, b in zip(val, other[key]))
            diff = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(val, other[key]))
            print(f"{key}: the two builds agree bit for bit: {same} (rel diff {diff:.3e})")


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if len(sys.argv) < 3 or sys.argv[1] not in ("times", "bits"):
        sys.exit(__doc__)
    dev = torch.device("cuda", 0)
    cuda_build.load_library()
    if sys.argv[1] == "times":
        times(sys.argv[2], dev)
    else:
        bits(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else None, dev)


if __name__ == "__main__":
    main()
