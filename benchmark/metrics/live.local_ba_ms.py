"""Local BA ms a frame: the program's ``local_bundle_adjust`` section
(which holds ``ba_dispatch_deferred``) plus ``ba_collect_deferred``."""
from harness.stats import timer_ms_per_frame


def read(rec):
    if rec["kind"] != "live":
        return None
    return timer_ms_per_frame(rec, ("local_bundle_adjust",
                                    "ba_collect_deferred"))
