"""Share of the live window's ORB extractions that replayed their
geometry's CUDA graph: the program's ``extract.replay`` counter over its
``extract.extraction`` counter (0 where the program replays none); ``None``
where the program's spans did not run (no ``session.add_frame``) or no
extraction was counted."""


def read(rec):
    timer = rec["timer"]
    if rec["kind"] != "live" or "session.add_frame" not in timer:
        return None
    extractions = timer.get("extract.extraction", [0.0, 0])[1]
    if not extractions:
        return None
    return timer.get("extract.replay", [0.0, 0])[1] / extractions
