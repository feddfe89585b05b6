"""Arithmetic the metric readers share."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values``, by linear interpolation
    between the closest ranks (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def idle_pct(trace):
    """100 * (1 - device busy / wall) of a traced stretch, the wall less
    the idle time inside the profiler's own buffer flushes (the card waits
    on the profiler there, not on the program); None untraced."""
    if not trace:
        return None
    wall = trace["traced_s"] - trace.get("flush_idle_s", 0.0)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / wall)


def timer_ms_per_frame(rec, sections) -> float:
    """Milliseconds a window frame in the program's ``utils/timer``
    ``sections`` (sections the window never entered count 0)."""
    total = sum(rec["timer"].get(s, [0.0, 0])[0] for s in sections)
    return 1e3 * total / rec["frames"]
