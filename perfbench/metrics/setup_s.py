"""``setup_s``: seconds from the process's start to the window's: imports,
the kernels' build where the checkout has none, the inputs, and the
warm-up that captures the cell's iteration graphs."""

NAME, UNIT, SOURCE, LAYER, MOVES = "setup_s", "s", "host_clock", None, None


def read(run):
    return run.setup_s
