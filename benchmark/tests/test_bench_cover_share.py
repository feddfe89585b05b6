"""``live.ba_cover_share`` on made-up records: the program's ``ba.cover``
counter over ``ba.cover`` + ``ba.replay``, 0 where the program replays
buckets and covers none, and ``None`` without the program's spans, in a
fleet record or with no BA call served by a graph."""
import pytest

from harness import spec

NAME = "live.ba_cover_share"


def _rec(kind, timer):
    return {"kind": kind, "timer": dict(timer), "spans": {}, "frames": 100,
            "traced_frames": 4, "chunks": 10}


@pytest.mark.parametrize("covers,replays,want", [
    (0, 120, 0.0), (30, 90, 0.25), (40, 0, 1.0)])
def test_reads_covers_over_graph_served_calls(covers, replays, want):
    timer = {"session.add_frame": [1.0, 100]}
    if covers:
        timer["ba.cover"] = [0.0, covers]
    if replays:
        timer["ba.replay"] = [0.0, replays]
    assert spec.reader(NAME)(_rec("live", timer)) == pytest.approx(want)


@pytest.mark.parametrize("kind,timer", [
    ("live", {}),
    ("live", {"ba.cover": [0.0, 5], "ba.replay": [0.0, 50]}),
    ("live", {"session.add_frame": [1.0, 100]}),
    ("fleet", {"session.add_frame": [1.0, 100], "ba.cover": [0.0, 5],
               "ba.replay": [0.0, 50]})],
    ids=["untraced", "no-program-spans", "nothing-replayed", "fleet"])
def test_none_without_what_it_reads(kind, timer):
    assert spec.reader(NAME)(_rec(kind, timer)) is None


def test_listed_for_both_live_cells():
    from conftest import ROOT

    man = spec.manifest(ROOT)
    (m,) = [m for m in man["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["euroc-mav.live", "kitti-odom.live"]
    assert (m["layer"], m["moves"], m["source"]) == (
        "local BA", "frames_per_s", "program_counter")
