"""Host ms a chunk in dispatching the device state's rebase after accepted
closures (the program's ``slam.rebase`` span), over the window's chunks; 0
where the consumer ran (``slam.consume``) and accepted no closure."""


def read(rec):
    timer = rec["timer"]
    if rec["kind"] != "fleet" or "slam.consume" not in timer \
            or not rec["chunks"]:
        return None
    return 1e3 * timer.get("slam.rebase", [0.0, 0])[0] / rec["chunks"]
