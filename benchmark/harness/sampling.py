"""Seeded samples of the answers a window produced."""
from __future__ import annotations

import numpy as np


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    drawn from ``rng`` (reservoir sampling). ``offer`` takes a function that
    makes the item, called only when the item is kept, so that copying a
    large item costs only the calls that keep it."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.seen = 0
        self._items = []

    def offer(self, make) -> None:
        self.seen += 1
        if len(self._items) < self.k:
            self._items.append(make())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self._items[j] = make()

    def items(self) -> list:
        return list(self._items)
