"""K1's share of its roofline in the fleet window: the least time of its
calls (``harness/peaks.k1_least_s``) over their profiled device time."""
from harness.peaks import k1_roofline_pct


def read(rec):
    if rec["kind"] != "fleet":
        return None
    return k1_roofline_pct(rec)
