"""``trial_ms``: what a scenario sweep pays a trial, all the window's time
over all the trials completed in it (host clock)."""

NAME, UNIT, SOURCE, LAYER, MOVES = "trial_ms", "ms", "host_clock", None, None


def read(run):
    if run.kind != "trial_batch" or not run.batches:
        return None
    return run.window_s * 1e3 / sum(b.trials for b in run.batches if not b.traced)
