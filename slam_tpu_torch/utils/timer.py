"""Section timers for pipeline tracing.

Rebuild of the reference's RAII section timers (`timer(slam::TIME_STATS, name)`
wrapping every pipeline stage, e.g. mapper_helpers.cpp:72,238,278,...) and the
host ``util::TimeStats`` aggregator. A global `TIME_STATS` can be enabled to
collect per-stage wall-clock; `jax.profiler` traces can be layered on top for
device-side detail.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Optional


class TimeStats:
    """Per-stage wall-clock aggregator (equivalent of util::TimeStats)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._frame_started = False

    def start_frame(self) -> None:
        self._frame_started = True

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def table(self) -> str:
        rows = ["stage                          total_s   calls   ms/call"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t = self.totals[name]
            c = self.counts[name]
            rows.append(f"{name:<30} {t:8.3f} {c:7d} {1e3 * t / max(c, 1):9.3f}")
        return "\n".join(rows)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


# Global hook, mirroring slam::TIME_STATS. None = timing disabled.
TIME_STATS: Optional[TimeStats] = None


def enable_timing() -> TimeStats:
    global TIME_STATS
    TIME_STATS = TimeStats()
    return TIME_STATS


def disable_timing() -> None:
    global TIME_STATS
    TIME_STATS = None


def section(name: str):
    """Context manager: time a named sub-stage when timing is enabled."""
    if TIME_STATS is None:
        return contextlib.nullcontext()
    return TIME_STATS.time(name)


def timed(fn):
    """Decorator: time the function under its own name when enabled."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if TIME_STATS is None:
            return fn(*args, **kwargs)
        with TIME_STATS.time(fn.__name__):
            return fn(*args, **kwargs)

    return wrapper
