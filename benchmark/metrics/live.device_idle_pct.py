"""Share of the traced stretch of the live window in which no operation
ran on the card: 100 * (1 - busy / wall), the wall less the idle time
inside the profiler's own buffer flushes (``harness/stats.idle_pct``)."""
from harness.stats import idle_pct


def read(rec):
    if rec["kind"] != "live":
        return None
    return idle_pct(rec.get("trace"))
