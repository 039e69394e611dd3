"""Host-side visualization (matplotlib / networkx, both optional).

Counterpart of ``dpilqr_tpu/utils/viz.py``; both libraries are imported on
first use, so neither is needed to import the package.  Arrays may be
numpy or tensors (copied to the host once).  Capability parity with the
reference's graphics module
(dpilqr/graphics.py): trajectory plots, interaction-graph rendering,
pairwise-distance plots, animated trajectory GIFs, scenario eyeballing --
operating on the block layout ``X: (T, n, nx_p)``.
"""

from __future__ import annotations

from itertools import cycle

import numpy as np
import torch

from .geometry import pairwise_distances


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _np(a):
    """``a`` as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _distances(X, n_pos=None):
    """``pairwise_distances`` of a host trajectory, as numpy."""
    return pairwise_distances(torch.as_tensor(_np(X)), n_pos=n_pos).numpy()


def set_bounds(xydata, ax=None, zoom: float = 0.1):
    """Frame the axis a margin beyond the data (reference graphics.py:26-44)."""
    plt = _plt()
    xydata = np.atleast_2d(_np(xydata))
    ax = ax or plt.gca()
    xm = np.ptp(xydata[:, 0]) * zoom
    ym = np.ptp(xydata[:, 1]) * zoom
    ax.set(
        xlim=(xydata[:, 0].min() - xm, xydata[:, 0].max() + xm),
        ylim=(xydata[:, 1].min() - ym, xydata[:, 1].max() + ym),
    )


def plot_solve(X, J, xf, color_agents: bool = True, n_d: int = 2, ax=None):
    """Plot trajectories, starts and goals (reference graphics.py:93-143).

    ``X: (T, n, nx_p)``, ``xf: (n, nx_p)``.
    """
    plt = _plt()
    X = _np(X)
    xf = _np(xf)
    n = X.shape[1]
    cm = plt.cm.tab20

    if ax is None:
        ax = (
            plt.gca()
            if n_d == 2
            else plt.gcf().add_subplot(projection="3d")
        )

    for i in range(n):
        c = cm.colors[i % len(cm.colors)] if color_agents else None
        if n_d == 2:
            ax.plot(X[:, i, 0], X[:, i, 1], c=c, lw=3)
            ax.scatter(X[0, i, 0], X[0, i, 1], 60, c="g", marker="d")
            ax.scatter(xf[i, 0], xf[i, 1], 60, c="r", marker="x")
        else:
            ax.plot(X[:, i, 0], X[:, i, 1], X[:, i, 2], c=c, lw=3)
            ax.scatter(X[0, i, 0], X[0, i, 1], X[0, i, 2], s=40, c="w",
                       edgecolors="k", marker="d")
            ax.scatter(xf[i, 0], xf[i, 1], xf[i, 2], s=40, c="k", marker="x")
    plt.title(f"Final Cost: {float(J):.3g}")
    return ax


def plot_interaction_graph(graph: dict, ax=None):
    """Spring-layout rendering of ``{id: [member ids]}``
    (reference graphics.py:69-90)."""
    plt = _plt()
    import networkx as nx

    graph = {k: [v for v in vs if v != k] for k, vs in graph.items()}
    G = nx.Graph(graph)
    options = {
        "font_size": 10,
        "node_size": 600,
        "node_color": plt.cm.Set3.colors[: len(graph)],
        "edgecolors": "black",
    }
    nx.draw_networkx(G, nx.spring_layout(G, k=0.5), ax=ax, **options)
    plt.margins(0.1)


def plot_pairwise_distances(X, radius, n_pos=None, ax=None):
    """All pairwise distances over time with the proximity line
    (reference graphics.py:146-156)."""
    plt = _plt()
    ax = ax or plt.gca()
    d = _distances(X, n_pos=n_pos)
    ax.plot(d)
    ax.axhline(radius, color="r", ls="--", label="$d_{prox}$")
    ax.set(
        title="Inter-Agent Distances",
        xlabel="Time Steps",
        ylabel="Pairwise Distance (m)",
    )
    ax.legend()
    return ax


def eyeball_scenario(x0, xf, ax=None):
    """Arrows from starts to goals (reference graphics.py:239-252)."""
    plt = _plt()
    x0 = _np(x0)
    xf = _np(xf)
    ax = ax or plt.gca()
    ax.set_aspect("equal")
    for i in range(x0.shape[0]):
        ax.annotate(
            "",
            xf[i, :2],
            x0[i, :2],
            arrowprops=dict(facecolor=plt.cm.tab20.colors[i % 20]),
        )
    set_bounds(np.r_[x0[:, :2], xf[:, :2]], ax, zoom=0.2)
    return ax


def make_trajectory_gif(gifname: str, X, xf, radius: float, fps=None):
    """Animated trajectory + distance evolution GIF
    (reference graphics.py:159-236)."""
    plt = _plt()
    from matplotlib.animation import FuncAnimation

    X = _np(X)
    xf = _np(xf)
    T, n = X.shape[0], X.shape[1]
    distances = _distances(X)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 6))
    lines, circles = [], []
    for _, c in zip(range(n), cycle(plt.cm.tab20.colors)):
        (ln,) = ax1.plot([], [], c=c, marker="o", markersize=4)
        circ = plt.Circle((np.nan, np.nan), radius, color="k", alpha=0.3)
        ax1.add_artist(circ)
        lines.append(ln)
        circles.append(circ)
    for i in range(n):
        ax1.scatter(xf[i, 0], xf[i, 1], c="r", marker="x", zorder=10)
    set_bounds(X[:, :, :2].reshape(-1, 2), ax1, zoom=0.15)
    ax1.set_title("Trajectories")

    dlines = [ax2.plot([], [], c=c)[0] for _, c in zip(
        range(distances.shape[1]), cycle(plt.cm.tab20.colors))]
    ax2.axhline(radius, color="r", ls="--", label="$d_{prox}$")
    ax2.set(xlim=(0, T), ylim=(0, distances.max() * 1.05),
            title="Inter-Distances", xlabel="Time Step", ylabel="Distance [m]")
    ax2.legend()

    def animate(t):
        for i, (ln, circ) in enumerate(zip(lines, circles)):
            ln.set_data(X[:t, i, 0], X[:t, i, 1])
            if t > 0:
                circ.set_center(X[t - 1, i, :2])
        for k, dl in enumerate(dlines):
            dl.set_data(np.arange(t), distances[:t, k])
        return (*lines, *dlines)

    anim = FuncAnimation(fig, animate, frames=T + 1, repeat=True)
    anim.save(gifname, fps=fps or max(T // 10, 1), dpi=100)
    plt.close(fig)
