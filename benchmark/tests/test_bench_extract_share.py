"""``live.extract_replay_share`` on made-up records: the program's
``extract.replay`` counter over its ``extract.extraction`` counter, 0 where
the program counts extractions and no replay, and ``None`` without the
program's spans, in a fleet record or with no extraction counted."""
import pytest

from harness import spec

NAME = "live.extract_replay_share"


def _rec(kind, timer):
    return {"kind": kind, "timer": dict(timer), "spans": {}, "frames": 100,
            "traced_frames": 4, "chunks": 10}


@pytest.mark.parametrize("replays,extractions,want", [
    (200, 200, 1.0), (150, 200, 0.75), (0, 200, 0.0)])
def test_reads_replays_over_extractions(replays, extractions, want):
    timer = {"session.add_frame": [1.0, 100],
             "extract.extraction": [0.0, extractions]}
    if replays:
        timer["extract.replay"] = [0.0, replays]
    assert spec.reader(NAME)(_rec("live", timer)) == pytest.approx(want)


@pytest.mark.parametrize("kind,timer", [
    ("live", {}),
    ("live", {"extract.extraction": [0.0, 200], "extract.replay": [0.0, 200]}),
    ("live", {"session.add_frame": [1.0, 100]}),
    ("fleet", {"session.add_frame": [1.0, 100],
               "extract.extraction": [0.0, 200],
               "extract.replay": [0.0, 200]})],
    ids=["untraced", "no-program-spans", "no-extraction", "fleet"])
def test_none_without_what_it_reads(kind, timer):
    assert spec.reader(NAME)(_rec(kind, timer)) is None


def test_listed_for_the_live_cell():
    from conftest import ROOT

    man = spec.manifest(ROOT)
    (m,) = [m for m in man["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["euroc-mav.live"]
    assert (m["layer"], m["moves"], m["source"]) == (
        "extractor", "frames_per_s", "program_counter")
