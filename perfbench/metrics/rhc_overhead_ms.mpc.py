"""``rhc_overhead_ms.mpc``: the receding-horizon loop's own time a step
(``parallel/rhc.py``): the window's time outside the program's
``RhcStepInfo.solve_time`` (dispatch to the step's one device-to-host
copy), over the window's steps (a traced run's slice comes after the
window)."""

NAME, UNIT, SOURCE = "rhc_overhead_ms.mpc", "ms", "program_span"
LAYER, MOVES = "RHC loop (parallel/rhc.py)", "step_ms"


def read(run):
    steps = [s for s in run.steps if not s.traced]
    if run.kind != "closed_loop" or not steps:
        return None
    return (run.untraced_s - sum(s.solve_s for s in steps)) * 1e3 / len(steps)
