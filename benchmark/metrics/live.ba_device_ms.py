"""Device ms a frame in the BA graphs' replays (local, neighbour and pose
BAs): CUDA events around each replay on the caller's stream, read when the
result is collected (the program's ``ba.replay_device`` entry)."""
from harness.stats import timer_ms_per_frame


def read(rec):
    if rec["kind"] != "live" or "ba.replay_device" not in rec["timer"]:
        return None
    return timer_ms_per_frame(rec, ("ba.replay_device",))
