"""Host ms a chunk in copying the chunk's images and odometry into the
graph's input buffers through pinned memory (the program's ``vo.copy_in``
span), over the window's chunks."""


def read(rec):
    t = rec["timer"].get("vo.copy_in")
    if rec["kind"] != "fleet" or not t or not rec["chunks"]:
        return None
    return 1e3 * t[0] / rec["chunks"]
