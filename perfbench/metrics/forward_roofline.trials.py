"""``forward_roofline.trials``: the forward line-search kernel's share of
its roofline over the traced slice: the published-peak bound of the work
the slice's solves needed (``harness/work.py`` ``needed_work``: the probe's
alphas an iteration and the warm start's rollout a solve) over the device
time of the kernel below."""

from perfbench.harness.work import role_roofline

NAME, UNIT, SOURCE = "forward_roofline.trials", "%", "device_trace"
LAYER = "Forward line-search kernel K2 (csrc/forward_batched.cu)"
MOVES = "trial_ms"
# K2: the probe, the tail and the warm start's rollout.
KERNELS = ("forward_batched_kernel",)


def read(run):
    if run.kind != "trial_batch":
        return None
    return role_roofline(run, "forward", KERNELS)
