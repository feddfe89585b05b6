"""Device busy time (the union of the profiler's device intervals) a
chunk, over the traced chunks of the fleet window (ms)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "fleet" or not t or not rec["traced_chunks"]:
        return None
    return 1e3 * t["busy_s"] / rec["traced_chunks"]
