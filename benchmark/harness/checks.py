"""The comparison that decides ``correct``: each number a driver's
``judge`` works out with the plain reference once the window has closed,
held to its limit from ``cells/<cell>.json``. Every number is "no more
than its limit"; ``PERF.md`` gives the readings each limit was set from."""
from __future__ import annotations

import math


def compare(numbers: dict, limits: dict) -> dict:
    """{name: {value, limit, ok}} for every limited number; a number the
    run did not produce, or that is not finite, fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        ok = v is not None and math.isfinite(v) and v <= limit
        out[name] = {"value": v, "limit": limit, "ok": bool(ok)}
    return out
