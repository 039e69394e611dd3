#!/usr/bin/env python3
"""Compare two trees of the PyTorch/CUDA port on one card, inside one call.

Run it from the root of each tree in turns (parent, change, change, parent:
two calls may land on two hosts, and the loops' step times are host-bound).
It needs one CUDA device and only ``chip_smoke.py`` and the package of the
tree it runs in, so it also runs in an older tree it is copied into:

    python3 scripts/compare_builds.py times TAG
    python3 scripts/compare_builds.py backward TAG [MATCH]
    python3 scripts/compare_builds.py forward TAG
    python3 scripts/compare_builds.py bits OUT.pt [OTHER.pt]

Each mode first prints the seconds the tree's default library took to
build (0 where it was built before).

``times`` prints, each line starting with TAG: the plain rollout on K4
(``sweeps.rollout_cuda``) beside the torch loop ``_rollout_batched_cost`` at
100 Unicycle4D, 64 Quad6D and 500 Unicycle4D agents; then ms per MPC step,
mean iterations, converged fraction and J of the smoke's loops (main path
twice, once under ``t_kill`` = 0.1 s, the quad6d_64 loop at K=16 twice and
at auto K once, 100 user bicycles once), the 8 x 100 Unicycle4D trials batch
(``solve_trials_sharded``, float32) twice, ``ilqr_solve`` twice and the
centralized MPC step.

``backward`` times the decomposed backward pass, float32 unless a shape
says float64, at the shapes phases 3a, 3b and 7c of ``chip_smoke.py`` time:
``backward_pass_batched`` on CUDA tensors as a whole (in a tree whose K1 and
K3 take their inputs from the torch prep, the prep and the launch) and the
launch alone (CUDA events around the kernel), K3 forced at nxf 32 too,
K3 at Quad6D K=32 (nxf 192) at S=16 and S=64 in both types, and K3 at the
hetero_99 fleet's K=32 (nxf 160) at S=33 and S=99 in float32; with MATCH,
only the shapes whose label holds it (``"K=32"``: the cluster tier's).

``forward`` times the forward kernels' launches alone (CUDA events, the
least of 20), with gains, at the shapes where a step's whole gain block
fits a CTA: K2 at 100 Unicycle4D K=8 (2 and 10 alphas), Quad6D at K=16,
Quad12D at K=8 (2 alphas), Quad6D at K=32 S=16 (2 and 10 alphas, float32
and float64); K4 at the 10-agent centralized shape (10 alphas, both types).

``bits`` saves the outputs of the three backward kernels (K1 and K3 on the
same narrow batches, K3 at Quad6D K=16 and at K=32, S=16 and S=64, and at
the hetero_99 fleet's K=32, S=33 and S=99, K5 at 10 agents) and of the two
forward ones at the smoke's phase 3a and 3c shapes (K2 at 100 Unicycle4D,
K=8, 2 and 10 alphas, with and without gains; K4 with gains at 10 agents
over 10 alphas and without at 100), float64 and float32, to OUT.pt; given
OTHER.pt from another tree it says for every output whether the two builds
agree bit for bit, and whether K1 agrees with K3.

K1 and K3 are called through ``forced_backward``, which takes either tree's
wrapper: one whose kernel computes its inputs, or one that takes them from
the torch prep.
"""

import inspect
import os
import re
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


def backward_args(fleet, cost, x0, K, dev, **kw):
    """``(fleet, sub_cost, mids, X, U, mu)`` of a batch as ``chip_smoke``'s
    ``sweep_inputs`` makes it (mu spread over [0.5, 1.5]), in either tree."""
    _, sub_cost, mids, carry = cs.sweep_inputs(fleet, cost, x0, K, dev, **kw)
    mu = torch.linspace(0.5, 1.5, carry.X.shape[0], dtype=carry.X.dtype, device=dev)
    return fleet, sub_cost, mids, carry.X, carry.U, mu


def forced_backward(kernel, args):
    """K1 (``kernel`` "narrow") or K3 ("wide") on a batch's arguments,
    through the tree's own wrapper: one that takes the batch, or one that
    takes the torch prep's tensors (then the prep runs first)."""
    fn = (bt.backward_pass_batched_cuda if kernel == "narrow"
          else bt.backward_pass_batched_wide_cuda)
    if "fleet" in inspect.signature(fn).parameters:
        return fn(*args)
    fleet, cost_b, mids, X, U, mu = args
    q = bt._quadraticize_batch(cost_b, X, U)
    A, B = bt._linearize_batch(fleet, cost_b, mids, X, U)
    return fn(A, B, q["L_uu"], q["L_xx"], q["L_x"], q["L_u"], mu, q["p0"], q["P0"])


def quad6d_k32(dtype, dev):
    """The quad6d_64 loop's widest batch: 64 Quad6D at K=32 (nxf 192, S=64)
    about hover, as ``backward_args`` makes it."""
    fleet, cost, x0 = cs.quad_problem(dtt.QUAD_6D, 64, 0.7, dtype, dev)
    return backward_args(fleet, cost, x0, 32, dev, u_scale=0.01, u_trim=np.array([G, 0, 0]))


def hetero99_k32(dtype, dev):
    """The hetero99 loop's widest batch: the hetero_99 configuration's 99
    agents (DoubleInt4D, Car3D and Bike5D in turn, swapping with a
    neighbour at 0.75) at K=32 (nxf 160, nuf 64, S=99)."""
    fleet = dtt.Fleet.from_names(["DoubleInt4D", "Car3D", "Bike5D"] * 33, cs.DT)
    x4, xf4 = cs.swap_scenario(fleet.n_agents, 0.75)
    cost, x0 = cs.problem(fleet, x4, xf4, dtype, dev)
    return backward_args(fleet, cost, x0, 32, dev, seed=1)


def backward(tag, dev, match=""):
    def shapes():
        for dtype in (torch.float64, torch.float32):
            fleet, cost, x0 = cs.unicycle_problem(cs.N_AGENTS, 0.55, dtype, dev)
            args = backward_args(fleet, cost, x0, 8, dev)
            yield f"K1 Unicycle4D K=8 S=100 {str(dtype)[6:]}", "narrow", args
        yield "K3 Unicycle4D K=8 S=100 (nxf 32)", "wide", args
        for K in (1, 2, 4, 6):
            yield f"K1 routing nxf {4 * K}", "narrow", backward_args(fleet, cost, x0, K, dev)
        fleet, cost, x0 = cs.unicycle_problem(128, 0.55, torch.float32, dev)
        big = backward_args(fleet, cost, x0, 8, dev)
        for S in (16, 32, 64, 128):
            yield f"K1 S={S}", "narrow", (big[0], type(big[1])(
                *(a[:S].contiguous() for a in big[1])), *(a[:S].contiguous()
                                                        for a in big[2:]))
        fleet = dtt.Fleet.from_names(["DoubleInt4D", "Car3D", "Bike5D"] * 4, cs.DT)
        x4, xf4 = cs.swap_scenario(fleet.n_agents, 0.55)
        cost, x0 = cs.problem(fleet, x4, xf4, torch.float32, dev)
        yield "K1 mixed DoubleInt4D+Car3D+Bike5D K=4", "narrow", backward_args(
            fleet, cost, x0, 4, dev, seed=1)
        for model, K, u_scale, trim in (
                (dtt.QUAD_6D, 8, 0.01, [G, 0, 0]), (dtt.QUAD_6D, 16, 0.01, [G, 0, 0]),
                (dtt.QUAD_12D, 8, 1e-7, [0, 0, 0, G * 63 / 2000])):
            dtypes = (torch.float32, torch.float64) if K == 16 else (torch.float32,)
            for dtype in dtypes:
                fleet, cost, x0 = cs.quad_problem(model, 64, 0.7, dtype, dev)
                yield (f"K3 {model.name} K={K} nxf {K * fleet.nx_p} {str(dtype)[6:]}",
                       "wide", backward_args(fleet, cost, x0, K, dev, u_scale=u_scale,
                                             u_trim=np.array(trim)))
        for dtype in (torch.float32, torch.float64):
            a = quad6d_k32(dtype, dev)
            yield (f"K3 Quad6D K=32 nxf 192 S=16 {str(dtype)[6:]}", "wide",
                   cs.cut_args(a, slice(None, None, 4)))
            yield f"K3 Quad6D K=32 nxf 192 S=64 {str(dtype)[6:]}", "wide", a
        a = hetero99_k32(torch.float32, dev)
        yield "K3 hetero_99 K=32 nxf 160 S=33 float32", "wide", cs.cut_args(
            a, slice(None, None, 3))
        yield "K3 hetero_99 K=32 nxf 160 S=99 float32", "wide", a
        fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, cs.N_AGENTS, cs.DT)
        parts = []
        for t in range(8):
            x0_t, xf_t = cs.swap_scenario(cs.N_AGENTS, 1.25, seed=t)
            cost = cs.problem(fleet, x0_t, xf_t, torch.float32, dev)[0]
            parts.append(backward_args(fleet, cost, x0_t, 8, dev, seed=t))
        yield "K1 trials S=800", "narrow", (
            fleet, type(parts[0][1])(*(torch.cat(f) for f in zip(*(p[1] for p in parts)))),
            *(torch.cat([p[i] for p in parts]) for i in (2, 3, 4, 5)))

    for label, kernel, args in shapes():
        if match not in label:
            continue
        name = "backward_batched" if kernel == "narrow" else "backward_batched_wide"
        whole = cs.timed(lambda: forced_backward(kernel, args), 10)
        with cuda_build.timed_launches() as record:
            for _ in range(10):
                forced_backward(kernel, args)
        launch = min(cuda_build.launch_ms(record, name))
        print(f"{tag} backward {label}: whole {whole:.4f} ms, the launch alone "
              f"{launch:.4f} ms", flush=True)


def trials(tag, dev, T=8, K=8):
    """The smoke's phase 7c batch: T trials of 100 Unicycle4D at K as one
    ``solve_trials_sharded`` batch on one card, float32, twice after a
    warm-up."""
    from dpilqr_tpu_torch.parallel.mesh import stack_costs

    fleet = dtt.homogeneous_fleet(dtt.UNICYCLE_4D, cs.N_AGENTS, cs.DT)
    costs, X_T, U_T = [], [], []
    for t in range(T):
        x0_t, xf_t = cs.swap_scenario(cs.N_AGENTS, 1.25, seed=t)
        costs.append(cs.problem(fleet, x0_t, xf_t, torch.float32, dev)[0])
        X_T.append(x0_t[None])
        U_T.append(np.random.default_rng(t).uniform(size=(cs.HORIZON, cs.N_AGENTS, 2))
                   * 0.01)
    X_T, U_T = np.stack(X_T).astype(np.float32), np.stack(U_T).astype(np.float32)
    cfg = dtt.SolverConfig(n_lqr_iter=15, tol=1e-3)
    mesh = dtt.make_mesh([dev])
    for run in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = dtt.solve_trials_sharded(fleet, stack_costs(costs), X_T, U_T, cs.RADIUS, mesh,
                                     K, config=cfg)
        torch.cuda.synchronize()
        if run:
            print(f"{tag} trials {T} x {cs.N_AGENTS} Unicycle4D K={K} float32: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms, mean iterations "
                  f"{float(r.iters.float().mean())}, converged "
                  f"{float(r.converged.float().mean())}", flush=True)


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
    loop("quad6d_64 auto K", fleet, cost, x0, 1)
    bike = dtt.homogeneous_fleet(cs.user_bike_class()(cs.DT).spec, cs.N_AGENTS, cs.DT)
    cost, x0 = cs.problem(bike, *cs.swap_scenario(cs.N_AGENTS, 1.25), torch.float32, dev)
    loop("100 user bicycles", bike, cost, x0, 1)
    trials(tag, dev)
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


def forward(tag, dev):
    def k2_shapes():
        for dtype in (torch.float32,):
            fleet, cost, x0 = cs.unicycle_problem(cs.N_AGENTS, 0.55, dtype, dev)
            yield "Unicycle4D K=8 S=100", fleet, cost, x0, 8, {}, None, (2, 10)
        for model, K, u_scale, trim in (
                (dtt.QUAD_6D, 16, 0.01, [G, 0, 0]),
                (dtt.QUAD_12D, 8, 1e-7, [0, 0, 0, G * 63 / 2000])):
            fleet, cost, x0 = cs.quad_problem(model, 64, 0.7, torch.float32, dev)
            yield (f"{model.name} K={K} S=64", fleet, cost, x0, K,
                   dict(u_scale=u_scale, u_trim=np.array(trim)), None, (2,))
        for dtype in (torch.float32, torch.float64):
            fleet, cost, x0 = cs.quad_problem(dtt.QUAD_6D, 64, 0.7, dtype, dev)
            yield (f"Quad6D K=32 S=16 {str(dtype)[6:]}", fleet, cost, x0, 32,
                   dict(u_scale=0.01, u_trim=np.array([G, 0, 0])), slice(None, None, 4),
                   (2, 10))

    def least(fn, kernel):
        with cuda_build.timed_launches() as record:
            for _ in range(20):
                fn()
        return min(cuda_build.launch_ms(record, kernel))

    for label, fleet, cost, x0, K, kw, cut, alphas_n in k2_shapes():
        _, sub_cost, mids, carry = cs.sweep_inputs(fleet, cost, x0, K, dev, **kw)
        args = backward_args(fleet, cost, x0, K, dev, **kw)
        if cut is not None:
            sub_cost = type(sub_cost)(*(a[cut].contiguous() for a in sub_cost))
            carry = type(carry)(*(a[cut].contiguous() for a in carry))
            mids = mids[cut].contiguous()
            args = (args[0], sub_cost, mids, carry.X, carry.U, args[5][cut].contiguous())
        Kg, d = bt.backward_pass_batched(*args, "cuda")
        for n_alpha in alphas_n:
            alphas = dtt.ops.line_search_alphas(n_alpha, carry.X.dtype, dev)
            ms = least(lambda: bt.forward_pass_batched_cuda(
                fleet, sub_cost, mids, carry.X, carry.U, Kg, d, alphas), "forward_batched")
            print(f"{tag} forward K2 {label} {n_alpha} alphas: the launch alone "
                  f"{ms:.4f} ms", flush=True)
    for dtype in (torch.float32, torch.float64):
        fleet, cost, x0 = cs.centralized_inputs(dtype, dev)
        x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
        U0 = torch.as_tensor(np.random.default_rng(2).uniform(size=(cs.HORIZON, 10, 2)) * 0.1,
                             dtype=dtype, device=dev)
        X = ilqr._rollout_fn(fleet.step, cost, x0, U0)[0]
        K, d = ilqr._backward_pass(fleet.linearize, cost, X, U0,
                                   torch.tensor(1.0, dtype=dtype, device=dev))
        alphas = dtt.ops.line_search_alphas(10, dtype, dev)
        ms = least(lambda: sweeps.forward_pass_cuda(fleet, cost, X, U0, K, d, alphas),
                   "forward_sweep")
        print(f"{tag} forward K4 10 Unicycle4D 10 alphas {str(dtype)[6:]}: the launch "
              f"alone {ms:.4f} ms", flush=True)


def same_bits(a, b):
    """Whether two outputs hold the same bits (NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def bits(out_path, other_path, dev):
    out = {}
    for names, K in ((["Unicycle4D"], 8), (["Unicycle4D"], 4), (["Unicycle4D"], 1),
                     (["Car3D"], 5), (["Bike5D"], 6), (["Quad6D"], 5)):
        for dtype in (torch.float64, torch.float32):
            fleet = dtt.Fleet.from_names(names * 12, cs.DT)
            x4, xf4 = cs.swap_scenario(fleet.n_agents, 0.55)
            cost, x0 = cs.problem(fleet, x4, xf4, dtype, dev)
            args = backward_args(fleet, cost, x0, K, dev, seed=1)
            key = f"{names[0]} K={K} {str(dtype)[6:]}"
            out[f"K1 {key}"] = [t.cpu() for t in forced_backward("narrow", args)]
            out[f"K3 {key}"] = [t.cpu() for t in forced_backward("wide", args)]
    for dtype in (torch.float64, torch.float32):
        fleet, cost, x0 = cs.quad_problem(dtt.QUAD_6D, 64, 0.7, dtype, dev)
        args = backward_args(fleet, cost, x0, 16, dev, u_scale=0.01,
                             u_trim=np.array([G, 0, 0]))
        out[f"K3 Quad6D K=16 {str(dtype)[6:]}"] = [
            t.cpu() for t in forced_backward("wide", args)]
        args = quad6d_k32(dtype, dev)
        for label, a in (("S=16", cs.cut_args(args, slice(None, None, 4))), ("S=64", args)):
            out[f"K3 Quad6D K=32 {label} {str(dtype)[6:]}"] = [
                t.cpu() for t in forced_backward("wide", a)]
        args = hetero99_k32(dtype, dev)
        for label, a in (("S=33", cs.cut_args(args, slice(None, None, 3))), ("S=99", args)):
            out[f"K3 hetero_99 K=32 {label} {str(dtype)[6:]}"] = [
                t.cpu() for t in forced_backward("wide", a)]
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
        _, sub_cost, mids, carry = cs.sweep_inputs(fleet, cost, x0, 8, dev)
        Kg, d = bt.backward_pass_batched(*backward_args(fleet, cost, x0, 8, dev), "torch")
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
            same = all(same_bits(a, b) for a, b in zip(val, out["K3" + key[2:]]))
            print(f"{key}: K1 and K3 agree bit for bit: {same}")
    if other_path:
        other = torch.load(other_path)
        for key, val in out.items():
            if key not in other:
                print(f"{key}: not in {other_path}")
                continue
            same = all(same_bits(a, b) for a, b in zip(val, other[key]))
            diff = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(val, other[key]))
            print(f"{key}: the two builds agree bit for bit: {same} (rel diff {diff:.3e})")


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if len(sys.argv) < 3 or sys.argv[1] not in ("times", "backward", "forward", "bits"):
        sys.exit(__doc__)
    dev = torch.device("cuda", 0)
    lib, build_s = cuda_build.build(verbose=True)
    print(f"{sys.argv[2]} build: {build_s:.1f} s", flush=True)
    for source in ("backward_batched", "backward_batched_wide", "forward_batched",
                   "forward_sweep"):
        if (lib.parent / f"{source}.log").exists():
            regs = cuda_build.ptxas_report(lib, source, f"{source}_kernel")
            rows = []
            for name, value in sorted(regs.items()):
                args = ",".join(re.findall(r"L[ib](\d+)E", name))
                rows.append(f"{'f' if 'kernelIf' in name else 'd'}<{args}> {value}")
            print(f"{sys.argv[2]} {source} registers and spill bytes: " + ", ".join(rows),
                  flush=True)
    cuda_build.load_library()
    if sys.argv[1] == "times":
        times(sys.argv[2], dev)
    elif sys.argv[1] == "backward":
        backward(sys.argv[2], dev, sys.argv[3] if len(sys.argv) > 3 else "")
    elif sys.argv[1] == "forward":
        forward(sys.argv[2], dev)
    else:
        bits(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else None, dev)


if __name__ == "__main__":
    main()
