"""Share of the live window's BA calls served by a captured graph that a
larger, covering bucket took: the program's ``ba.cover`` counter over
``ba.cover`` + ``ba.replay`` (0 where the program covers none); ``None``
where the program's spans did not run (no ``session.add_frame``) or no BA
call was served by a graph."""


def read(rec):
    timer = rec["timer"]
    if rec["kind"] != "live" or "session.add_frame" not in timer:
        return None
    covers = timer.get("ba.cover", [0.0, 0])[1]
    served = covers + timer.get("ba.replay", [0.0, 0])[1]
    if not served:
        return None
    return covers / served
