"""Layout ``crossing``, which the tests bring in as a later configuration
would: the controlled agents stand on a circle and swap with the agent
opposite; the uncontrolled agents start on parallel lines left of the
circle, with goals to its right.  They do not get there: the program,
like the upstream project, leaves an uncontrolled agent's stitched rows at
zero, so in a closed loop it stands at the origin from the second step on,
an obstacle in the circle's middle.  ``spacing`` is the gap between
neighbours on the circle and between the lines; the seed jitters the
controlled agents' starts and goals."""

import numpy as np


def make(n, nx_p, spacing, seed, groups):
    rng = np.random.default_rng(seed)
    ctl = np.concatenate([np.full(int(g["count"]), bool(g["controlled"])) for g in groups])
    x0, xf = np.zeros((n, nx_p)), np.zeros((n, nx_p))
    m = int(ctl.sum())
    ang = 2 * np.pi * np.arange(m) / m
    r = spacing * m / (2 * np.pi)
    circle = r * np.stack([np.cos(ang), np.sin(ang)], -1)
    x0[ctl, :2] = circle + rng.uniform(-0.05, 0.05, circle.shape)
    xf[ctl, :2] = -circle + rng.uniform(-0.05, 0.05, circle.shape)
    ys = spacing * (np.arange(n - m) - (n - m - 1) / 2)
    x0[~ctl, 0], x0[~ctl, 1] = -r - spacing, ys
    xf[~ctl, 0], xf[~ctl, 1] = r + spacing, ys
    return x0, xf
