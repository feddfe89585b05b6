"""Loop closer ms a frame: the program's ``try_loop_closure`` section."""
from harness.stats import timer_ms_per_frame


def read(rec):
    if rec["kind"] != "live":
        return None
    return timer_ms_per_frame(rec, ("try_loop_closure",))
