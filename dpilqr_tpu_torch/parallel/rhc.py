"""Receding-horizon control driver, centralized or decomposed.

Counterpart of ``dpilqr_tpu/parallel/rhc.py`` (reference ``solve_rhc``,
distributed.py:106-221): a host loop that solves (``ilqr_solve`` on the
whole fleet, or ``solve_distributed``), advances ``step_size`` steps and
shift-and-pads the warm start.  Trajectories stay on the solve's device;
each step fetches only its loop-control scalars (J, goal distances and, when
decomposed, the largest neighborhood and the truncation flag).

The subproblem width follows the JAX package's schedule exactly: under
auto-K a step is solved with the width chosen from the steps resolved
before its predecessor (the JAX loop dispatches step k+1 before it
resolves step k), widths grow at once and shrink with hysteresis, and a
truncated step is redone from the same warm state with a wider K.

With ``t_kill`` every step's solve is capped at that much wall time
(``ilqr_solve_steppable`` / ``solve_distributed_steppable``), and, as in the
JAX loop, which does not pipeline under a deadline, a step then uses the
width resolved from its predecessor.  ``log_fn`` sees each committed step's
record; ``checkpoint_path`` saves the loop state after every step
(``utils/checkpoint.py``) and ``resume_state`` continues from one.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from time import perf_counter

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SolverConfig, resolve_device
from ..models.fleet import Fleet
from ..ops.costs import GameCost, cast_cost
from ..ops.ilqr import ilqr_solve_steppable, rollout
from ..utils.checkpoint import RhcState, save_rhc_state
from ..utils.geometry import distance_to_goal
from ..utils.profiling import span
from .distributed import solve_distributed
from .graph import graph_to_dict


@dataclass
class RhcStepInfo:
    """Per-MPC-step record (the reference's solve_info + CSV row,
    distributed.py:187-194); ``graph`` renders from ``membership`` on
    access."""

    t: float
    J: float
    solve_time: float
    membership: np.ndarray | None = None  # None when centralized
    iters: list = field(default_factory=list)
    distance_left: list = field(default_factory=list)
    K: int | None = None  # subproblem width the step was solved at
    k_max: int | None = None  # largest neighborhood of the step's graph
    converged: list = field(default_factory=list)  # per-(sub)problem flags

    @property
    def graph(self) -> dict | None:
        return None if self.membership is None else graph_to_dict(self.membership)


@dataclass
class RhcResult:
    X: np.ndarray  # (T, n, nx_p) executed trajectory
    U: np.ndarray  # (T, n, nu_p) executed controls
    J: float  # joint cost of the executed plan
    converged: bool
    steps: list = field(default_factory=list)  # list[RhcStepInfo]


def _advance_shift(X, U, xf, step_size: int, n_d: int):
    """Advance the simulated system and shift-and-pad the warm start
    (reference distributed.py:178-185).  Returns ``(xi, X_exec, U_exec,
    X_warm, U_warm, dists)``."""
    xi = X[step_size]
    X_warm = torch.cat([X[step_size:], X[-1:].expand(step_size, *X.shape[1:])])
    U_warm = torch.cat([U[step_size:], U.new_zeros((step_size, *U.shape[1:]))])
    dists = distance_to_goal(xi, xf, n_d)
    return xi, X[:step_size], U[:step_size], X_warm, U_warm, dists


def _to_host(*tensors) -> list[np.ndarray]:
    """``tensors`` on the host in one copy: packed into one float64 buffer
    (each value a float, a bool or an integer below 2**53, so exact), then
    unpacked to each tensor's dtype and shape."""
    host = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        dtype = torch.empty((0,), dtype=t.dtype).numpy().dtype
        out.append(host[at:at + t.numel()].astype(dtype).reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _pow2(k: int) -> int:
    return 1 << (k - 1).bit_length() if k > 1 else 1


def solve_rhc(
    fleet: Fleet,
    cost: GameCost,
    x0,
    N: int,
    radius: float | None = None,
    centralized: bool = True,
    step_size: int = 1,
    J_converge: float | None = None,
    dist_converge: float | None = None,
    n_d: int = 2,
    t_diverge: float | None = None,
    t_kill: float | None = None,
    ignore_mask=None,
    K: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
    rng: np.random.Generator | None = None,
    U0=None,
    verbose: bool = False,
    log_fn=None,
    checkpoint_path=None,
    resume_state=None,
    device=None,
) -> RhcResult:
    """Receding-horizon solve, centralized (one ``ilqr_solve`` over the
    fleet per step) or decomposed (``solve_distributed``).

    Exactly one of ``J_converge`` (stop when J drops below) or
    ``dist_converge`` (stop when every agent is within this distance of its
    goal) must be given (reference distributed.py:125-143); ``t_diverge``
    aborts after that much simulated time; ``t_kill`` caps the wall clock
    of each step's solve (reference control.py:213-218).  The first warm
    start is ``U0 (N, n, nu_p)`` or else small random controls drawn from
    ``rng``.  ``log_fn(info)`` is called with each committed step's
    ``RhcStepInfo``; ``checkpoint_path`` gets the loop state after every
    step and ``resume_state`` (a ``utils.checkpoint.RhcState``) continues a
    run from one.  The solve runs in ``x0``'s dtype; a tensor ``x0`` keeps
    its device, numpy input goes to ``device`` (default: the card,
    ``config.default_device``).
    """
    if (J_converge is None) == (dist_converge is None):
        raise ValueError("Specify exactly one of J_converge or dist_converge")
    if not centralized and radius is None:
        raise ValueError("Decomposed mode needs the proximity radius")

    with span("dpilqr.rhc.episode"):
        n, nx_p, nu_p = fleet.n_agents, fleet.nx_p, fleet.nu_p
        dt = fleet.dt
        X_exec_parts: list[torch.Tensor] = []
        U_exec_parts: list[torch.Tensor] = []
        step_count = 0
        with span("dpilqr.rhc.setup"):
            dev = resolve_device(device, x0)
            x0 = x0.cpu().numpy() if isinstance(x0, torch.Tensor) else np.asarray(x0)
            if not np.issubdtype(x0.dtype, np.floating):
                x0 = x0.astype(float)
            x0 = x0.reshape(n, nx_p)
            dtype = torch.float32 if x0.dtype == np.float32 else torch.float64
            cost = cast_cost(GameCost(*(a.to(dev) for a in cost)), dtype)
            xf = cost.xf

            if resume_state is not None:
                # Resume a checkpointed run (utils/checkpoint.py).
                def on_dev(a):
                    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

                xi = on_dev(resume_state.xi)
                X = on_dev(resume_state.X_warm)
                U = on_dev(resume_state.U_warm)
                t = resume_state.t
                X_exec_parts.append(on_dev(resume_state.X_full))
                U_exec_parts.append(on_dev(resume_state.U_full))
                step_count = resume_state.step
            else:
                if U0 is not None:
                    if isinstance(U0, torch.Tensor):
                        U0 = U0.cpu().numpy()
                    U_np = np.asarray(U0, dtype=x0.dtype)
                    if U_np.shape != (N, n, nu_p):
                        raise ValueError(
                            f"U0 must be (N, n, nu_p) = {(N, n, nu_p)}, got {U_np.shape}"
                        )
                elif rng is None:
                    raise ValueError("pass U0 or an rng for the random warm start")
                else:
                    # Small random warm start (reference distributed.py:152).
                    U_np = (rng.uniform(size=(N, n, nu_p)) * 0.01).astype(x0.dtype)
                U_np = U_np * np.asarray(fleet.control_mask, x0.dtype)[None]
                U = torch.as_tensor(U_np, device=dev)
                xi = torch.as_tensor(x0, device=dev)
                X = xi[None]  # (1, n, nx) until the first solve
                t = 0.0

            dists = (
                distance_to_goal(xi, xf, n_d).cpu().numpy()
                if dist_converge is not None else None
            )

        def stop(J, dists):
            if J_converge is not None:
                return J < J_converge
            return bool(np.all(dists <= dist_converge))

        converged = True
        steps: list[RhcStepInfo] = []
        K_cur = K

        def dispatch(t_step, xi_cur, X_w, U_w, K_use):
            t0 = perf_counter()
            if centralized:
                # With t_kill None this is ilqr_solve.
                res = ilqr_solve_steppable(fleet, cost, xi_cur, U0=U_w,
                                           config=config, t_kill=t_kill)
            else:
                res = solve_distributed(
                    fleet, cost, X_w, U_w, radius, ignore_mask=ignore_mask,
                    K=K_use, config=config, t_kill=t_kill,
                )
            with span("dpilqr.rhc.advance"):
                xi_n, X_exec, U_exec, X_n, U_n, dists_dev = _advance_shift(
                    res.X, res.U, xf, step_size, n_d
                )
            return {
                "t": t_step, "t0": t0, "res": res, "K_used": K_use,
                "X_exec": X_exec, "U_exec": U_exec, "xi": xi_n, "X": X_n,
                "U": U_n, "dists": dists_dev,
                "xi_in": xi_cur, "X_in": X_w, "U_in": U_w,
            }

        def resolve(rec):
            """Commit a step.  Returns (stop, diverged, redo); with ``redo``
            nothing was committed and the step must be solved again with the
            widened ``K_cur``."""
            nonlocal K_cur
            res = rec["res"]
            # The step's one device-to-host copy (the JAX loop's jax.device_get).
            with span("dpilqr.rhc.read"):
                if centralized:
                    J_h, dists_h, iters_h, conv_h = _to_host(
                        res.J, rec["dists"], res.iters, res.converged)
                else:
                    J_h, dists_h, kmax, trunc, memb_h, iters_h, conv_h = _to_host(
                        res.J, rec["dists"], res.sizes.max(), res.truncated,
                        res.membership, res.iters, res.converged)
            J_h = float(J_h)
            solve_time = perf_counter() - rec["t0"]
            if centralized:
                info = RhcStepInfo(
                    t=rec["t"], J=J_h, solve_time=solve_time,
                    iters=[int(iters_h)], distance_left=dists_h.tolist(),
                    converged=[bool(conv_h)],
                )
                return commit(rec, info)
            kmax = int(kmax)
            if bool(trunc):
                # A neighborhood outgrew the slot count.  Under auto-K redo the
                # step wider than the width it used; with a pinned K, warn.
                K_used = rec["K_used"]
                if K is None and K_used is not None and K_used < n:
                    K_cur = min(max(_pow2(kmax), K_used * 2), n)
                    return False, False, True
                warnings.warn(
                    f"neighborhood exceeded the subproblem width K={K_used}: "
                    "coupling partners were dropped from some subproblem(s)",
                    RuntimeWarning,
                    stacklevel=3,
                )
            if K is None:
                # Grow at once; shrink with hysteresis.
                k_need = min(_pow2(kmax), n)
                if K_cur is None or k_need > K_cur or k_need <= K_cur // 2:
                    K_cur = k_need

            return commit(rec, RhcStepInfo(
                t=rec["t"], J=J_h, solve_time=solve_time, membership=memb_h,
                iters=iters_h.tolist(), distance_left=dists_h.tolist(),
                K=rec["K_used"] or min(_pow2(kmax), n), k_max=kmax,
                converged=conv_h.tolist(),
            ))

        def commit(rec, info):
            nonlocal converged, step_count
            with span("dpilqr.rhc.commit"):
                X_exec_parts.append(rec["X_exec"])
                U_exec_parts.append(rec["U_exec"])
                steps.append(info)
                step_count += 1
                if checkpoint_path is not None:
                    # The NEXT step's simulated time, so that a resumed run goes
                    # on exactly where this one stopped.
                    save_rhc_state(checkpoint_path, RhcState(
                        xi=rec["xi"].cpu().numpy(), X_warm=rec["X"].cpu().numpy(),
                        U_warm=rec["U"].cpu().numpy(), t=rec["t"] + step_size * dt,
                        X_full=torch.cat(X_exec_parts).cpu().numpy(),
                        U_full=torch.cat(U_exec_parts).cpu().numpy(), step=step_count,
                    ))
            if log_fn is not None:
                with span("dpilqr.rhc.log_fn"):
                    log_fn(info)
            if verbose:
                print(f"t: {info.t:.3g}\tJ: {info.J:g}\tsolve: {info.solve_time:.3g}s")
            diverged = t_diverge is not None and info.t >= t_diverge
            if diverged:
                converged = False
            return stop(info.J, np.asarray(info.distance_left)), diverged, False

        if not stop(np.inf, dists):
            step, redo = (t, xi, X, U, K_cur), False
            while True:
                # The JAX loop dispatches the next step before resolving this
                # one, so the next step uses the width from before this
                # resolve; under a deadline it does not pipeline, and the next
                # step uses the width this resolve settles.
                K_before = K_cur
                with span("dpilqr.rhc.step"):
                    if redo:
                        with span("dpilqr.rhc.redo"):
                            rec = dispatch(*step)
                    else:
                        rec = dispatch(*step)
                    stopped, diverged, redo = resolve(rec)
                K_next = K_before if t_kill is None else K_cur
                if redo:
                    step = (rec["t"], rec["xi_in"], rec["X_in"], rec["U_in"], K_cur)
                    continue
                if stopped or diverged:
                    break
                step = (rec["t"] + step_size * dt, rec["xi"], rec["X"], rec["U"], K_next)

        # Executed trajectory and its joint cost (distributed.py:206-211).
        with span("dpilqr.rhc.rollout"):
            x0_t = torch.as_tensor(x0, device=dev)
            if X_exec_parts:
                Xc = torch.cat(X_exec_parts)
                Uc = torch.cat(U_exec_parts)
                _, J_full = rollout(fleet, cast_cost(cost, dtype), x0_t, Uc)
                X_full, U_full = Xc.cpu().numpy(), Uc.cpu().numpy()
            else:
                # Immediate convergence without optimization
                # (distributed.py:206-208).
                X_full = x0[None].copy()
                U_full = np.zeros((1, n, nu_p), x0.dtype)
                _, J_full = rollout(fleet, cast_cost(cost, dtype), x0_t,
                                    torch.as_tensor(U_full, device=dev))
            J_full = float(J_full)
        return RhcResult(X=X_full, U=U_full, J=J_full, converged=converged,
                         steps=steps)


def selfish_warmstart(fleet: Fleet, cost: GameCost, x0, N: int,
                      config: SolverConfig = DEFAULT_CONFIG, device=None):
    """Per-agent solo warm start (reference problem.py:66-91): every agent's
    tracking problem ignoring all others, as one decomposed solve on the
    empty graph (``K=1``, so no width sync).  Returns ``U (N, n, nu_p)`` on
    ``x0``'s device when it is a tensor, else on ``device`` (default: the
    card)."""
    x0 = torch.as_tensor(x0, device=resolve_device(device, x0))
    U0 = x0.new_zeros((N, fleet.n_agents, fleet.nu_p))
    # radius <= 0: no pair is ever within 2 * radius, a singleton graph.
    res = solve_distributed(fleet, cost, x0[None], U0, radius=-1.0, K=1,
                            config=config)
    return res.U
