"""95th percentile, over the frames of the live window, of the time from
handing a frame to the tracker to its pose ``Result`` (ms). Read in the
traced run: its spread (11-20 % over a set of six runs on the room) is too
wide for an end-to-end bound. The few frames that the profiler's stretch
touched are left out."""
from harness.stats import percentile


def read(rec):
    if rec["kind"] != "live":
        return None
    return 1e3 * percentile(rec["untraced_latencies_s"], 95)
