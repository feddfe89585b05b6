"""Host mapping ms a frame: the time in ``Slam.add_frame`` (benchmark's
wrapper) less the BA (local, collected, pose, global), the loop closer and
the Mapper's extraction wait, which other metrics read."""
from harness.stats import timer_ms_per_frame

OTHERS = ("local_bundle_adjust", "ba_collect_deferred", "pose_bundle_adjust",
          "global_bundle_adjust", "try_loop_closure")


def read(rec):
    add = rec["spans"].get("live.add_frame")
    if rec["kind"] != "live" or not add or not rec["timer"]:
        return None
    extract = sum(rec["spans"].get("live.extract.mapper", []))
    return (1e3 * (sum(add) - extract) / rec["frames"]
            - timer_ms_per_frame(rec, OTHERS))
