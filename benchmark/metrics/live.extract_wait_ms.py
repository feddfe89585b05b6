"""Host ms a frame that the tracker's and the Mapper's extractions wait for
their results to reach pinned memory (the program's ``extract.wait``
span)."""
from harness.stats import timer_ms_per_frame


def read(rec):
    if rec["kind"] != "live" or "extract.wait" not in rec["timer"]:
        return None
    return timer_ms_per_frame(rec, ("extract.wait",))
