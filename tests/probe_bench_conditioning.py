"""How well conditioned ``bench_torch.py``'s cold point is at the size its
parity test runs (``tests/test_torch_bench.py``); CPU, float64, 20 s.

Run from the repository root:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/probe_bench_conditioning.py

8 unicycles of ``bench.py``'s mirrored grid, K = 8, at N = 10 and N = 6.
For each horizon: the port's cold solve (``bench_torch.cold_solve``)
against the JAX package's ``_solve_distributed`` (XLA sweeps), relative J
and whether the iterations are equal; and the JAX package against itself
with x0 moved by 1e-14.  Where the JAX package moves further against itself
than against the port, the gap is the scenario's conditioning (ROADMAP C4).
"""

import os
import tempfile

# A compile cache of this run's own (as tests/conftest.py does).
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(prefix="jax_dpilqr_probe_")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
import bench_torch as bt  # noqa: E402
import dpilqr_tpu as dtl  # noqa: E402
from dpilqr_tpu.config import SolverConfig  # noqa: E402
from dpilqr_tpu.parallel.distributed import _solve_distributed  # noqa: E402

n, K = 8, bt.K_SLOTS


def jax_cold(x0, xf, N):
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    cost = dtl.make_game_cost(
        jnp.asarray(xf), jnp.asarray(np.tile(np.eye(4), (n, 1, 1))),
        jnp.asarray(np.tile(np.eye(2), (n, 1, 1))),
        jnp.asarray(np.tile(1e3 * np.eye(4), (n, 1, 1))), radius=0.5)
    X0 = jnp.broadcast_to(jnp.asarray(x0)[None], (N + 1, n, 4))
    cfg = SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend="xla")
    return _solve_distributed(fleet, cfg, K, None, cost, X0, jnp.zeros((N, n, 2)),
                              jnp.asarray(0.5), jnp.zeros((n,), bool))


def rel(a, b):
    return abs(float(a.J) - float(b.J)) / abs(float(b.J))


for N in (10, 6):
    x0, xf = bench._grid_scenario(n)
    rj = jax_cold(x0, xf, N)
    rj_moved = jax_cold(x0 + 1e-14, xf, N)
    s = bt.Setting(device=torch.device("cpu"), dtype=torch.float64, horizon=N, reps=1)
    rt = bt.cold_solve(s, *bt.grid_problem(s, n), K)
    print(f"N={N}: port vs JAX rel J {rel(rt, rj):.3e}, iterations equal "
          f"{np.array_equal(rt.iters.numpy(), np.asarray(rj.iters))}; JAX vs JAX with "
          f"x0 + 1e-14 rel J {rel(rj_moved, rj):.3e}")
