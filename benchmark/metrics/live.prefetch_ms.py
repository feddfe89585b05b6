"""Host ms a frame in ``Mapper.prefetch``: the next frame's extraction
enqueued (pack, pinned upload, the extraction's and K1's launches, the
pinned copies out; the program's ``mapper.prefetch`` span)."""
from harness.stats import timer_ms_per_frame


def read(rec):
    if rec["kind"] != "live" or "mapper.prefetch" not in rec["timer"]:
        return None
    return timer_ms_per_frame(rec, ("mapper.prefetch",))
