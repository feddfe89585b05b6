"""Device ms a chunk in the landmarks' bookkeeping (depth refinement,
creation, culling, the window's records), from the stamps the replayed
chunk writes on the card's clock at the end of each stage (the program's
``vo.device.landmarks`` timer entry, one a consumed chunk), over the
window's chunks."""


def read(rec):
    t = rec["timer"].get("vo.device.landmarks")
    if rec["kind"] != "fleet" or not t or not rec["chunks"]:
        return None
    return 1e3 * t[0] / rec["chunks"]
