"""Whether the port and the JAX package part by conditioning or by a fault
where K truncates neighbourhoods (ROADMAP C10); CPU, float64, a minute.

Run from the repository root:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/probe_c10.py

16 unicycles from ``random_setup`` (seed 2) at energies 10, 15 and 20,
whose neighbourhoods of 11-14 agents K = 4 truncates; N = 12,
``n_lqr_iter=15``.  For each energy: whether the two packages' memberships
and sizes are equal; the port's ``solve_distributed`` against
``dpilqr_tpu.solve_distributed`` (XLA sweeps), relative J and iterations;
and the JAX package against itself with x0 moved by 1e-14.  Where the
JAX package moves further against itself than against the port, the gap is
the scenario's conditioning (ROADMAP C4), not a port fault.
"""

import os
import tempfile

# A compile cache of this run's own: one written on another host's CPU
# features may not load here (as tests/conftest.py does).
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(prefix="jax_dpilqr_probe_")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import dpilqr_tpu as dtl  # noqa: E402
import dpilqr_tpu_torch as dtt  # noqa: E402

n, N, K, RADIUS = 16, 12, 4, 0.5


def scenario(energy):
    x0, xf = dtt.random_setup(n, 4, rng=np.random.default_rng(2), energy=energy, n_d=2)
    eye = np.eye(4)
    return x0, (xf, np.tile(eye, (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
                np.tile(1e3 * eye, (n, 1, 1)))


def jax_solve(x0, fields):
    return dtl.solve_distributed(
        dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1),
        dtl.make_game_cost(*fields, radius=RADIUS), jnp.asarray(x0)[None],
        jnp.zeros((N, n, 2)), RADIUS, K=K,
        config=dtl.SolverConfig(n_lqr_iter=15, sweep_backend="xla"))


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def main():
    print("energy | truncated | memberships equal | port vs JAX: rel J, "
          "iterations equal | JAX vs JAX(x0 + 1e-14): rel J, iterations equal")
    for energy in (10.0, 15.0, 20.0):
        x0, fields = scenario(energy)
        port = dtt.solve_distributed(
            dtt.homogeneous_fleet(dtt.UNICYCLE_4D, n, 0.1),
            dtt.make_game_cost(*fields, radius=RADIUS, device="cpu"),
            torch.as_tensor(x0)[None], torch.zeros((N, n, 2), dtype=torch.float64),
            RADIUS, K=K, config=dtt.SolverConfig(n_lqr_iter=15), device="cpu")
        ref = jax_solve(x0, fields)
        moved = jax_solve(x0 + 1e-14, fields)
        same_graph = (np.array_equal(port.membership.numpy(), np.asarray(ref.membership))
                      and np.array_equal(port.sizes.numpy(), np.asarray(ref.sizes)))
        print(f"{energy:g} | {bool(port.truncated)} (sizes up to "
              f"{int(port.sizes.max())}) | {same_graph} | "
              f"{rel(port.J, ref.J):.3e}, "
              f"{np.array_equal(port.iters.numpy(), np.asarray(ref.iters))} | "
              f"{rel(moved.J, ref.J):.3e}, "
              f"{np.array_equal(np.asarray(moved.iters), np.asarray(ref.iters))}",
              flush=True)


if __name__ == "__main__":
    main()
