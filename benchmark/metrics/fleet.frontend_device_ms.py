"""Device ms a chunk in the ORB front-end (pyramid, detection, orientation,
descriptors), from the stamps the replayed chunk writes on the card's clock
at the end of each stage (the program's ``vo.device.frontend`` timer entry,
one a consumed chunk), over the window's chunks."""


def read(rec):
    t = rec["timer"].get("vo.device.frontend")
    if rec["kind"] != "fleet" or not t or not rec["chunks"]:
        return None
    return 1e3 * t[0] / rec["chunks"]
