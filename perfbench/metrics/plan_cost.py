"""``plan_cost``: plan quality, the mean joint cost of a scenario's plan
over the scenarios whose plans the window completed (a closed loop's
executed plan, a trial's stitched plan), each scenario weighted once, as
the reference computes it on the host from the program's controls
(``harness/check.py`` ``plan_costs``), not read from the program.  Weighted
by scenario, a closed loop's pool reads the same whichever of its scenarios
the window's last cycle reached."""

from collections import defaultdict

NAME, UNIT, SOURCE, LAYER, MOVES = "plan_cost", "J", "host_clock", None, None


def read(run):
    if not run.plan_costs:
        return None
    by = defaultdict(list)
    for key, cost in run.plan_costs:
        by[key].append(cost)
    return sum(sum(v) / len(v) for v in by.values()) / len(by)
