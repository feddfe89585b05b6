"""BA graphs captured inside the live window: padded buckets that set-up's
prewarm missed, each run eagerly and then captured in the window (the
program's ``ba.capture`` counter); 0 where the program's spans ran
(``session.add_frame``) and no bucket was captured."""


def read(rec):
    timer = rec["timer"]
    if rec["kind"] != "live" or "session.add_frame" not in timer:
        return None
    return float(timer.get("ba.capture", [0.0, 0])[1])
