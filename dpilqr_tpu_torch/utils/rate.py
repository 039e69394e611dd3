"""Drift-free fixed-rate loop pacing for real-time MPC loops.

Equivalent of the reference's ROS2 rate machinery: the ``timer_sleep.py``
spin/rate-sleep scratch (reference timer_sleep.py:1-22) and the
``sleepForRate(GOTO_RATE)`` pacing inside the hardware MPC loop (reference
scripts/experiment.py:260).  Re-designed without rclpy: a monotonic-clock
``Rate`` that sleeps to *absolute* deadlines, so a slow iteration does not
shift every subsequent tick (the classic ``sleep(period)`` drift), and
overruns are counted rather than silently absorbed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Rate:
    """Paces a loop at ``hz`` iterations per second from the first call.

    ``sleep()`` blocks until the next absolute deadline ``t0 + k/hz`` and
    returns the time remaining when it was called (negative = deadline
    missed).  Missed deadlines advance to the next future tick instead of
    bursting to catch up, matching rclpy Rate semantics.
    """

    hz: float
    _period: float = field(init=False)
    _next: float | None = field(default=None, init=False)
    ticks: int = field(default=0, init=False)
    missed: int = field(default=0, init=False)

    def __post_init__(self):
        if self.hz <= 0:
            raise ValueError(f"rate must be positive, got {self.hz}")
        self._period = 1.0 / self.hz

    def reset(self) -> None:
        self._next = None
        self.ticks = 0
        self.missed = 0

    def remaining(self) -> float:
        """Seconds until the next deadline (negative if already missed)."""
        if self._next is None:
            return self._period
        return self._next - time.monotonic()

    def sleep(self) -> float:
        now = time.monotonic()
        if self._next is None:
            self._next = now + self._period
            self.ticks += 1
            return self._period
        slack = self._next - now
        if slack > 0:
            time.sleep(slack)
            self._next += self._period
        else:
            self.missed += 1
            # Skip past lost ticks; never burst.
            k = int((now - self._next) / self._period) + 1
            self._next += (k + 1) * self._period
        self.ticks += 1
        return slack
