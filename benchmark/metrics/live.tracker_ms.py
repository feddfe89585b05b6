"""Host ms a frame in ``DescriptorTracker.process``, from the benchmark's
wrapper, over the live window."""


def read(rec):
    s = rec["spans"].get("live.tracker")
    if rec["kind"] != "live" or not s:
        return None
    return 1e3 * sum(s) / rec["frames"]
