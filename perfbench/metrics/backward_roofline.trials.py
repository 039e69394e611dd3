"""``backward_roofline.trials``: the backward kernels' share of their
roofline over the traced slice: the published-peak bound of the work the
slice's solves needed (``harness/work.py`` ``needed_work``) over the device
time of the kernels below.  The map from kernel names to this role lives
here: a kernel that is renamed or fused in later adds a file, the count
stays."""

from perfbench.harness.work import role_roofline

NAME, UNIT, SOURCE = "backward_roofline.trials", "%", "device_trace"
LAYER = "Backward kernels K1, K3 (csrc/backward_batched.cu, backward_batched_wide.cu)"
MOVES = "trial_ms"
# K1 (narrow, nxf <= 32) and K3 (wide).
KERNELS = ("backward_batched_kernel", "backward_batched_wide_kernel")


def read(run):
    if run.kind != "trial_batch":
        return None
    return role_roofline(run, "backward", KERNELS)
