"""``rhc_idle_ms.mpc``: the device's idle milliseconds a traced step while
the receding-horizon loop's own host work held it: idle time of the traced
slice under the program's ``dpilqr.rhc.*`` spans (set-up, advance, the
step's read, commit, redo, the closing rollout), less the caller's
callback ``dpilqr.rhc.log_fn`` (``harness/spans.py``)."""

from perfbench.harness.spans import layer_idle_ms, traced_steps

NAME, UNIT, SOURCE = "rhc_idle_ms.mpc", "ms", "program_span"
LAYER, MOVES = "RHC loop (parallel/rhc.py)", "step_ms"


def read(run):
    if run.kind != "closed_loop":
        return None
    return layer_idle_ms(run, "rhc", traced_steps(run), exclude=("dpilqr.rhc.log_fn",))
