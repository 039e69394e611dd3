"""``host_reads.mpc``: the program's device-to-host reads a traced step:
its spans whose names end in ``.read`` in the traced slice (the batched
driver's active count after every iteration and once a solve, the auto-K
width, the step's one copy in the loop), over the traced steps.  It counts
the spans, so it reads on the CPU rehearsal too (``harness/spans.py``)."""

from perfbench.harness.spans import program_spans, traced_steps

NAME, UNIT, SOURCE = "host_reads.mpc", "reads", "program_counter"
LAYER, MOVES = "Batched driver (ops/batched.py)", "step_ms"


def read(run):
    steps = traced_steps(run)
    if run.kind != "closed_loop" or run.trace is None or not steps:
        return None
    spans = program_spans(run.trace)
    if not spans:
        return None
    return sum(name.endswith(".read") for name, _, _ in spans) / steps
