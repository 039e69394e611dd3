"""Structured metrics and logging.

Counterpart of ``dpilqr_tpu/utils/metrics.py``, with tensors accepted
wherever that module takes arrays or numbers (copied to the host once, at
the edge, by ``_plain``).  Two sinks:

- CSV rows with the reference's exact schema (scripts/analysis.py:120-123):
  ``dynamics,n_agents,trial,centralized,last,t,J,horizon,dt,converged,ids,
  times,subgraphs,dist_left`` -- so the reference's analysis notebooks keep
  working against our logs.
- JSON-lines records, one dict a line (``JsonlWriter``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

CSV_SCHEMA = (
    "dynamics,n_agents,trial,centralized,last,t,J,horizon,dt,converged,"
    "ids,times,subgraphs,dist_left"
)


def _plain(v):
    """``v`` with every tensor and numpy value in it (inside lists, tuples
    and dicts too) turned into Python numbers and lists."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def setup_csv_logger(path, name: str = "dpilqr_tpu_torch.analysis"):
    """File logger emitting the reference CSV schema
    (reference analysis.py:110-124)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    handler = logging.FileHandler(path, mode="w")
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
    logger.propagate = False
    logger.info(CSV_SCHEMA)
    return logger


def csv_row(
    model_name: str,
    n_agents: int,
    trial,
    centralized: bool,
    last: bool,
    t: float,
    J: float,
    horizon: int,
    dt: float,
    converged: bool,
    ids,
    times,
    subgraphs,
    dist_left,
) -> str:
    """One reference-schema row (reference distributed.py:190-194)."""
    t, J, ids, times, subgraphs, dist_left = (
        _plain(v) for v in (t, J, ids, times, subgraphs, dist_left))
    return (
        f'"{model_name}",{n_agents},{trial},{centralized},{last},{t},{J},'
        f'{horizon},{dt},{converged},"{ids}","{times}","{subgraphs}",'
        f'"{dist_left}"'
    )


def riccati_block_nnz(n_agents: int, nx: int, nu: int, N: int) -> int:
    """Nonzero block ENTRIES touched by one Riccati backward sweep
    (BASELINE.md north-star counter): per timestep the block backward pass
    touches the n^2 (nx, nx) P-coupling blocks plus n (nx, nx) A-blocks and
    n (nx, nu) B-blocks."""
    n = n_agents
    return N * (n * n * nx * nx + n * nx * nx + n * nx * nu)


class JsonlWriter:
    """Append-only JSON-lines metrics sink."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: dict):
        with self.path.open("a") as f:
            f.write(json.dumps(_plain(record)) + "\n")
