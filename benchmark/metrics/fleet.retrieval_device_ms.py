"""Device ms a chunk in loop retrieval (K1's quantisation, the ring's query
and store, the snapshot), from the stamps the replayed chunk writes on the
card's clock at the end of each stage (the program's
``vo.device.retrieval`` timer entry, one a consumed chunk), over the
window's chunks."""


def read(rec):
    t = rec["timer"].get("vo.device.retrieval")
    if rec["kind"] != "fleet" or not t or not rec["chunks"]:
        return None
    return 1e3 * t[0] / rec["chunks"]
