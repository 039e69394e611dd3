"""Solver configuration for dpilqr_tpu_torch.

Counterpart of ``dpilqr_tpu/config.py``: the same ``SolverConfig`` fields
and defaults.  Everything follows the dtype and device of the tensors
it is given (float64 for parity runs on the CPU, float32 on the card), so
there is no global precision switch and no compile cache.  Entry points
given numpy input and no device run on ``default_device()``, the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SWEEP_BACKENDS = ("auto", "cuda", "torch", "pscan")


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

    # Sweep implementation: "cuda" (the hand-written kernels in csrc/),
    # "torch" (their plain PyTorch twins), or "auto": the kernels for CUDA
    # tensors, the twins for CPU tensors.  "pscan" runs the centralized
    # solve's backward sweep as the log-depth associative scan of
    # ops/pscan.py (forward sweep as under "auto"); the centralized "auto"
    # takes it on the card where K5 finds no tier for the problem
    # (ops/ilqr.py resolve_sweep_backend); the decomposed solve has no scan
    # and reads it as "auto".  The environment variable DPILQR_SWEEP_BACKEND
    # (the same names) overrides it for every solve.
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


def default_device() -> torch.device:
    """The device an entry point runs on when its caller names none and
    passes no tensor: the current CUDA device.  Raises without one; it
    never returns the CPU (ask for that with ``device="cpu"`` or by passing
    CPU tensors)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dpilqr_tpu_torch runs on an NVIDIA GPU and torch.cuda finds no CUDA "
            'device; pass device="cpu" (or CPU tensors) to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device, *args) -> torch.device:
    """The device of an entry point's work: ``device`` when given, else the
    device of the first tensor among ``args`` (a tensor argument keeps its
    device), else ``default_device()``."""
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return default_device()


def resolve_backend(backend: str, t) -> str:
    """A batched sweep backend for tensors like ``t``: the
    ``DPILQR_SWEEP_BACKEND`` override if set (``ops.ilqr.env_sweep_backend``;
    it overrides an explicit ``backend`` too, as the JAX package's does),
    else ``backend``; "auto" (and "pscan", which only the centralized solve
    has) -> "cuda" for CUDA tensors, "torch" for CPU tensors; "cuda" and
    "torch" as given."""
    from .ops.ilqr import env_sweep_backend

    backend = env_sweep_backend() or backend
    if backend in ("auto", "pscan"):
        return "cuda" if t.is_cuda else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown sweep backend {backend!r}")
    return backend
