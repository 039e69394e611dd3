"""``decomp_idle_ms.mpc``: the device's idle milliseconds a traced step
while the decomposed solve's host work held it: idle time of the traced
slice under the program's ``dpilqr.distributed.*`` spans (the interaction
graph, the auto-K read, the gather, the stitch, the joint cost's rollout;
``harness/spans.py``)."""

from perfbench.harness.spans import layer_idle_ms, traced_steps

NAME, UNIT, SOURCE = "decomp_idle_ms.mpc", "ms", "program_span"
LAYER = "Graph and gather, decomposed solve (parallel/distributed.py)"
MOVES = "step_ms"


def read(run):
    if run.kind != "closed_loop":
        return None
    return layer_idle_ms(run, "distributed", traced_steps(run))
