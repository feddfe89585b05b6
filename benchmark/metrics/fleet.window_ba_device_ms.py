"""Device ms a chunk in the window BAs (``_window_ba``, every
``window_ba_every`` frames), from the stamps the replayed chunk writes on
the card's clock at the end of each stage (the program's
``vo.device.window_ba`` timer entry, one a consumed chunk), over the
window's chunks."""


def read(rec):
    t = rec["timer"].get("vo.device.window_ba")
    if rec["kind"] != "fleet" or not t or not rec["chunks"]:
        return None
    return 1e3 * t[0] / rec["chunks"]
