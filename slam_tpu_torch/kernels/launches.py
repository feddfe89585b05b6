"""Launch counts of the hand-written kernels.

Each kernel's wrapper adds the launches it makes to the kernel's
:class:`Counter`: a process-wide ``total``, a tally of the calling thread
and, while ``utils/timer`` is on, the timer's counter of the kernel's name.
A CUDA graph records the launches made while it is captured and runs none of
them, so a capture site captures inside :func:`capture`, which takes the
recorded launches back out, and calls :func:`replay` after each replay,
which adds them again. Concurrent sessions (``parallel/batch.py``) launch
and capture from several threads: the totals add under a lock, and a
capture reads only its own thread's tally.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

from slam_tpu_torch.utils import timer


class Counter:
    """The launches of one kernel, named as the timer's counter."""

    def __init__(self, name: str):
        self.name = name
        self.total = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def add(self, n: int) -> None:
        with self._lock:
            self.total += n
        self._local.n = self.thread_total() + n
        timer.count(self.name, n)

    def thread_total(self) -> int:
        """The launches this thread has added."""
        return getattr(self._local, "n", 0)


K1 = Counter("k1.launch")           # csrc/hamming_argmin.cu
GFTT = Counter("detect.launch")     # csrc/gftt_peaks.cu
ORB = Counter("orb.launch")         # csrc/orb_describe.cu
COUNTERS = (K1, GFTT, ORB)


def reset() -> None:
    """Zero every kernel's ``total``."""
    for c in COUNTERS:
        with c._lock:
            c.total = 0


@contextlib.contextmanager
def capture():
    """Around a CUDA graph capture on this thread: yields a dict that, on
    exit, holds the launches the capture recorded, by counter name, and
    takes them back out of the counters (none of them ran)."""
    before = [c.thread_total() for c in COUNTERS]
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        for c, n0 in zip(COUNTERS, before):
            n = c.thread_total() - n0
            if n:
                recorded[c.name] = n
                c.add(-n)


def replay(recorded: Dict[str, int]) -> None:
    """Add the launches of one replay of a graph that :func:`capture`
    recorded."""
    for c in COUNTERS:
        n = recorded.get(c.name, 0)
        if n:
            c.add(n)
