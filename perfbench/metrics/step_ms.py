"""``step_ms``: replanning latency of the closed loop, all the window's
time over all the MPC steps completed in it (host clock; the episodes'
cost construction, set-up and closing rollout included)."""

NAME, UNIT, SOURCE, LAYER, MOVES = "step_ms", "ms", "host_clock", None, None


def read(run):
    if run.kind != "closed_loop" or not run.steps:
        return None
    return run.window_s * 1e3 / sum(not s.traced for s in run.steps)
