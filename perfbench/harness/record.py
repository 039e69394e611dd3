"""What the check judges: a sample, drawn from the seed, of the solves the
window's own calls made.

The harness wraps functions of the program's modules by name for the
window's duration and keeps references to the inputs and outputs of the
calls it samples (reservoir sampling: ``k`` calls drawn uniformly from all
of them, whatever their number).  Nothing is copied or synchronised, so the
window's work is the program's own.  A sampled call also keeps the inputs
of the call after it, so that the check can follow the loop's advance."""

from __future__ import annotations

import numpy as np


class Reservoir:
    """``k`` items drawn uniformly from a stream, with ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> bool:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return True
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item
            return True
        return False


class Patch:
    """Replace attributes of modules for the length of a ``with`` block."""

    def __init__(self, *targets):
        self.targets = targets  # (module, name, replacement)
        self.saved = []

    def __enter__(self):
        for mod, name, new in self.targets:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)
        return self

    def __exit__(self, *exc):
        for mod, name, old in reversed(self.saved):
            setattr(mod, name, old)
        self.saved.clear()
        return False
