"""Every frame of every sequence the fleet window took in, over the
window's seconds (host clock; the window ends at ``finish`` and a
synchronise)."""


def read(rec):
    if rec["kind"] != "fleet":
        return None
    return rec["keyframes"] / rec["window_s"]
