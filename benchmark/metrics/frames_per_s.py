"""Frames whose ``Slam.add_frame`` future resolved inside the live window,
over the window's seconds (host clock)."""


def read(rec):
    if rec["kind"] != "live":
        return None
    return rec["frames"] / rec["window_s"]
