"""Solver configuration for dpilqr_tpu_torch.

Counterpart of ``dpilqr_tpu/config.py``: the same ``SolverConfig`` fields
and defaults.  Everything here follows the dtype and device of the tensors
it is given (float64 for parity runs on the CPU, float32 on the card), so
there is no global precision switch and no compile cache.
"""

from __future__ import annotations

from dataclasses import dataclass

SWEEP_BACKENDS = ("auto", "cuda", "torch")


@dataclass(frozen=True)
class SolverConfig:
    """Hyperparameters of the iLQR solve.

    Defaults mirror the reference solver (dpilqr/control.py:48-51,150):
    ``DELTA_0=2.0, MU_MIN=1e-6, MU_MAX=1e3, N_LS_ITER=10`` with
    ``n_lqr_iter=50`` outer iterations and relative tolerance ``1e-3``.
    """

    n_lqr_iter: int = 50
    tol: float = 1e-3
    delta_0: float = 2.0
    mu_min: float = 1e-6
    mu_max: float = 1e3
    n_ls_iter: int = 10
    mu_init: float = 1.0

    # The returned cost is the cost of the returned trajectory (J_star);
    # the reference's last-line-search-cost quirk is not copied.
    return_accepted_cost: bool = True

    # Failed-line-search policy: "bail" stops iterating (the reference's
    # actual behavior); "increase" raises mu by the delta schedule and keeps
    # iterating until mu exceeds ``mu_max``.
    on_failed_ls: str = "bail"

    # Batched sweep implementation: "cuda" (the hand-written kernels in
    # csrc/), "torch" (their plain PyTorch twins), or "auto": the kernels
    # for CUDA tensors, the twins for CPU tensors.
    sweep_backend: str = "auto"

    # Two-stage batched line search: evaluate the first ``ls_probe`` alphas
    # and launch the remaining ``n_ls_iter - ls_probe`` only when some active
    # subproblem improved at none of them.  The accept rule is the FIRST
    # improving alpha, so the decision is identical to the one-shot sweep.
    # 0 disables staging.
    ls_probe: int = 2

    # Conditioning guard (off = exact reference behavior): floor mu at
    # ``mu_min`` instead of snapping it to 0.
    mu_floor: bool = False

    def __post_init__(self):
        if self.sweep_backend not in SWEEP_BACKENDS:
            raise ValueError(
                f"sweep_backend={self.sweep_backend!r} is not one of "
                f"{SWEEP_BACKENDS}"
            )
        if self.on_failed_ls not in ("bail", "increase"):
            raise ValueError(f"unknown on_failed_ls={self.on_failed_ls!r}")


DEFAULT_CONFIG = SolverConfig()


def resolve_backend(backend: str, t) -> str:
    """A sweep backend for tensors like ``t``: "auto" -> "cuda" for CUDA
    tensors, "torch" for CPU tensors; "cuda" and "torch" as given."""
    if backend == "auto":
        return "cuda" if t.is_cuda else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown sweep backend {backend!r}")
    return backend
