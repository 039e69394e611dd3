"""Interaction graph construction.

Counterpart of ``dpilqr_tpu/parallel/graph.py``: agents within twice the
proximity radius of each other at any of ~10 sampled knots of the previous
trajectory are planned together (reference distributed.py:224-247).  The
graph is a dense boolean membership matrix ``M (n, n)``, ``M[i, j]`` True
iff agent j belongs to agent i's subproblem (diagonal always True).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.geometry import pair_indices, pairwise_distances


def interaction_graph(X, radius, n_pos=None, n_d: int | None = None,
                      n_samples: int = 10):
    """Threshold-distance interaction graph.

    ``X: (T, n, nx_p)`` previous trajectory (T >= 1); ``radius`` the
    proximity radius (planning radius ``2 * radius``, reference
    distributed.py:229).  Returns the ``(n, n)`` bool membership matrix.
    """
    T, n = X.shape[0], X.shape[1]
    step = max(T // n_samples, 1)
    Xs = X[::step]  # strided sampling (reference :233-236)
    d = pairwise_distances(Xs, n_pos=n_pos, n_d=n_d)  # (samples, npairs)
    close = torch.any(d < 2.0 * radius, dim=0)
    ii, jj = pair_indices(n)
    ii = torch.as_tensor(ii, device=X.device)
    jj = torch.as_tensor(jj, device=X.device)
    M = torch.eye(n, dtype=torch.bool, device=X.device)
    M[ii, jj] = close
    M[jj, ii] = close
    return M


def graph_to_dict(M, ids=None) -> dict:
    """Render a membership matrix as the reference's ``{id: [ids]}`` dict."""
    M = M.cpu().numpy() if isinstance(M, torch.Tensor) else np.asarray(M)
    n = M.shape[0]
    ids = list(range(n)) if ids is None else list(ids)
    return {
        ids[i]: sorted(ids[j] for j in range(n) if M[i, j]) for i in range(n)
    }
