"""Host ms a consumed chunk in ``DeviceSlam._consume`` (the closure
consumer), from the benchmark's wrapper, over the whole window."""


def read(rec):
    s = rec["spans"].get("fleet.consume")
    if rec["kind"] != "fleet" or not s:
        return None
    return 1e3 * sum(s) / len(s)
