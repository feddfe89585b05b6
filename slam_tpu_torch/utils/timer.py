"""Spans, counters and device durations for pipeline tracing.

Rebuild of the reference's RAII section timers (`timer(slam::TIME_STATS, name)`
wrapping every pipeline stage, e.g. mapper_helpers.cpp:72,238,278,...) and the
host ``util::TimeStats`` aggregator, grown into a span recorder. A global
`TIME_STATS` collects nothing until `enable_timing`. While it is on:

- every `section` and `@timed` call is a span: its name, its start and end on
  `time.perf_counter_ns`, and its parent, the innermost span open on the same
  thread. Each name keeps its total, its count and its self time (the span's
  duration less what its child spans cover);
- every span is also a `torch.profiler.record_function` of the same name, so
  a profiler trace (`utils/profiling.device_trace`) shows it on the host
  timeline, and the card's idle gaps can be put down to it;
- `count` adds to a counter, and `add_device` / `add` add a duration measured
  elsewhere (the card's clock; a host tally the program already keeps) to a
  name's total and count.

While it is off, nothing is recorded and `section` is a
`contextlib.nullcontext()`.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Set

import torch


class Span(NamedTuple):
    """One closed span. ``parent`` is the ``id`` of the span that was
    innermost on the same thread when it opened (-1 at the top level)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    thread: int


class TimeStats:
    """Per-name totals, counts and self times, and the closed spans
    (equivalent of util::TimeStats). Thread-safe: each thread keeps its own
    stack of open spans."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.self_totals: Dict[str, float] = defaultdict(float)
        self.device: Set[str] = set()     # names whose totals are card time
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def time(self, name: str):
        stack = self._stack()
        parent = stack[-1][0] if stack else -1
        frame = [next(self._ids), 0]          # id, ns its children cover
        with torch.profiler.record_function(name):
            stack.append(frame)
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                t1 = time.perf_counter_ns()
                stack.pop()
                dt = t1 - t0
                if stack:
                    stack[-1][1] += dt
                with self._lock:
                    self.totals[name] += dt * 1e-9
                    self.counts[name] += 1
                    self.self_totals[name] += (dt - frame[1]) * 1e-9
                    self.spans.append(Span(name, t0, t1, frame[0], parent,
                                           threading.get_ident()))

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (its total stays 0)."""
        with self._lock:
            self.totals[name] += 0.0
            self.counts[name] += n

    def add(self, name: str, seconds: float) -> None:
        """One host duration measured elsewhere, under ``name``."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def add_device(self, name: str, seconds: float) -> None:
        """One duration on the card's clock, under ``name``."""
        with self._lock:
            self.device.add(name)
            self.totals[name] += seconds
            self.counts[name] += 1

    def table(self) -> str:
        """One row a name, by total: spans with their self time, device
        durations marked ``device``, counters with a total of 0."""
        rows = ["stage                          total_s   calls   ms/call"
                "    self_s"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t = self.totals[name]
            c = self.counts[name]
            own = (f"{self.self_totals[name]:9.3f}" if name in self.self_totals
                   else "   device" if name in self.device else "        -")
            rows.append(f"{name:<30} {t:8.3f} {c:7d} {1e3 * t / max(c, 1):9.3f}"
                        f" {own}")
        return "\n".join(rows)

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.self_totals.clear()
            self.device.clear()
            self.spans.clear()


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
    """Context manager: a span ``name`` when timing is enabled."""
    stats = TIME_STATS
    if stats is None:
        return contextlib.nullcontext()
    return stats.time(name)


def timed_as(name: str):
    """Decorator: a span ``name`` around each call when enabled."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            stats = TIME_STATS
            if stats is None:
                return fn(*args, **kwargs)
            with stats.time(name):
                return fn(*args, **kwargs)

        return wrapper

    return decorate


def timed(fn):
    """Decorator: a span under the function's own name when enabled."""
    return timed_as(fn.__name__)(fn)


def count(name: str, n: int = 1) -> None:
    """``TimeStats.count`` when timing is enabled."""
    stats = TIME_STATS
    if stats is not None:
        stats.count(name, n)


def add(name: str, seconds: float) -> None:
    """``TimeStats.add`` when timing is enabled."""
    stats = TIME_STATS
    if stats is not None:
        stats.add(name, seconds)


def add_device(name: str, seconds: float) -> None:
    """``TimeStats.add_device`` when timing is enabled."""
    stats = TIME_STATS
    if stats is not None:
        stats.add_device(name, seconds)
