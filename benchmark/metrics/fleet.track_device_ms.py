"""Device ms a chunk in map matching and the pose LM (``_match_map`` through
``_pose_ba``), from the stamps the replayed chunk writes on the card's
clock at the end of each stage (the program's ``vo.device.track`` timer
entry, one a consumed chunk), over the window's chunks."""


def read(rec):
    t = rec["timer"].get("vo.device.track")
    if rec["kind"] != "fleet" or not t or not rec["chunks"]:
        return None
    return 1e3 * t[0] / rec["chunks"]
