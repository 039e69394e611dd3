"""Geometry and scenario utilities on the block layout ``(n, nx_p)``.

Counterpart of ``dpilqr_tpu/utils/geometry.py`` (reference dpilqr/util.py).
Pairwise functions take tensors; scenario generation is host numpy and
draws only from the ``np.random.Generator`` it is given.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def pair_indices(n: int):
    """Static (i, j) upper-triangle pair index arrays (combinations order)."""
    return np.triu_indices(n, k=1)


def pairwise_distances(X, n_pos=None, n_d: int | None = None):
    """All-pairs distances over a trajectory.

    ``X: (..., n, nx_p)`` -> ``(..., npairs)`` in ``itertools.combinations``
    order (reference util.py:48-61).  Per-pair dimensionality is
    ``min(n_pos_i, n_pos_j)`` (capped at 3), or a fixed ``n_d`` when given.
    """
    n = X.shape[-2]
    ii, jj = pair_indices(n)
    ii_t = torch.as_tensor(ii, device=X.device)
    jj_t = torch.as_tensor(jj, device=X.device)
    k = min(3, X.shape[-1])
    pos = torch.nn.functional.pad(X[..., :k], (0, 3 - k))
    if n_d is not None:
        nd_pair = torch.full((len(ii),), n_d, device=X.device)
    elif n_pos is not None:
        n_pos = torch.as_tensor(n_pos, device=X.device)
        nd_pair = torch.minimum(n_pos[ii_t], n_pos[jj_t])
    else:
        nd_pair = torch.full((len(ii),), 2, device=X.device)
    comp = torch.arange(3, device=X.device)[None, :] < nd_pair[:, None]
    delta = (pos[..., ii_t, :] - pos[..., jj_t, :]) * comp
    return torch.sqrt(torch.sum(delta * delta, dim=-1))


def distance_to_goal(x, xf, n_d: int = 2):
    """Per-agent distance from goal positions (reference util.py:239-240)."""
    return torch.linalg.vector_norm(x[..., :n_d] - xf[..., :n_d], dim=-1)


# --------------------------------------------------------------- scenarios
def randomize_locs(
    n_pts: int,
    rng: np.random.Generator,
    random: bool = False,
    rel_dist: float = 3.0,
    var: float = 3.0,
    n_d: int = 2,
):
    """Uniform random points with enforced minimum separation
    (reference util.py:125-149)."""
    delta = 0.1 * n_pts
    x = var * rng.uniform(-1, 1, (n_pts, n_d))
    if random:
        return x
    pair_inds = np.array(list(itertools.combinations(range(n_pts), 2)))
    while True:
        center = x.mean(axis=0)
        d = np.linalg.norm(x[pair_inds[:, 0]] - x[pair_inds[:, 1]], axis=1)
        close = pair_inds[d <= rel_dist]
        if not close.size:
            break
        move = np.unique(close)
        x[move] += delta * (x[move] - center)
    return x


def face_goal(x0, xf, heading_var: float = 0.01, *, rng: np.random.Generator):
    """Point the last state component at the goal with slight noise
    (reference util.py:152-162)."""
    dX = xf[:, :2] - x0[:, :2]
    headings = np.arctan2(dX[:, 1], dX[:, 0])
    x0 = x0.copy()
    xf = xf.copy()
    x0[:, -1] = headings + heading_var * rng.standard_normal(x0.shape[0])
    xf[:, -1] = headings + heading_var * rng.standard_normal(x0.shape[0])
    return x0, xf


def random_setup(
    n_agents: int,
    n_states: int,
    rng: np.random.Generator,
    is_rotation: bool = False,
    n_d: int = 2,
    energy: float | None = None,
    do_face: bool = False,
    **kwargs,
):
    """Random start/goal block states (reference util.py:165-195).

    Returns ``x0, xf`` of shape ``(n_agents, n_states)``; draws the same
    numbers as ``dpilqr_tpu.random_setup`` from the same generator state.
    """
    x_i = randomize_locs(n_agents, rng=rng, n_d=n_d, **kwargs)
    if is_rotation:
        theta = np.pi + rng.uniform(-np.pi / 4, np.pi / 4)
        R = np.array(
            [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
        )
        x_f = x_i @ R - x_i.mean(axis=0)
    else:
        x_f = randomize_locs(n_agents, rng=rng, n_d=n_d, **kwargs)

    x0 = np.c_[x_i, np.zeros((n_agents, n_states - n_d))]
    xf = np.c_[x_f, np.zeros((n_agents, n_states - n_d))]
    if do_face:
        x0, xf = face_goal(x0, xf, rng=rng)
    if energy:
        x0 = normalize_energy(x0, energy, n_d)
        xf = normalize_energy(xf, energy, n_d)
    return x0, xf


def compute_energy(x, n_d: int = 2):
    """Sum of position distances from the origin (reference util.py:198-200)."""
    return np.linalg.norm(np.asarray(x)[:, :n_d], axis=1).sum()


def normalize_energy(x, energy: float = 10.0, n_d: int = 2):
    """Zero-center positions and scale to the target energy
    (reference util.py:203-217)."""
    x = np.asarray(x).copy()
    x[:, :n_d] -= x[:, :n_d].mean(axis=0)
    x[:, :n_d] *= energy / compute_energy(x, n_d)
    return x


def perturb_state(x, rng: np.random.Generator, n_d: int = 2, var: float = 0.5):
    """Jitter positions to break symmetries (reference util.py:220-226)."""
    x = np.asarray(x).copy()
    x[:, :n_d] += var * rng.standard_normal(x[:, :n_d].shape)
    return x
