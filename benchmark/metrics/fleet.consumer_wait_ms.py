"""Host ms a chunk that the closure consumer waits for a chunk's outputs to
reach pinned memory (the program's ``slam.consume_wait`` span), over the
window's chunks."""


def read(rec):
    t = rec["timer"].get("slam.consume_wait")
    if rec["kind"] != "fleet" or not t or not rec["chunks"]:
        return None
    return 1e3 * t[0] / rec["chunks"]
