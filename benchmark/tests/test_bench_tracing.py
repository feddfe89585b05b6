"""The readers of the program's own spans, stamps and counters on made-up
records: each returns its number from the entry it reads, ms a chunk or a
frame (or a count), and ``None`` where the record lacks the entry, as a
traced run of a program without those spans gives."""
import pytest

from harness import spec

# metric -> (cell kind, timer entry, its [total s, count], expected value)
READS = {
    "fleet.frontend_device_ms": ("fleet", "vo.device.frontend", [0.5, 10],
                                 50.0),
    "fleet.track_device_ms": ("fleet", "vo.device.track", [0.3, 10], 30.0),
    "fleet.landmarks_device_ms": ("fleet", "vo.device.landmarks", [0.2, 10],
                                  20.0),
    "fleet.retrieval_device_ms": ("fleet", "vo.device.retrieval", [0.1, 10],
                                  10.0),
    "fleet.window_ba_device_ms": ("fleet", "vo.device.window_ba", [0.4, 10],
                                  40.0),
    "fleet.copy_in_ms": ("fleet", "vo.copy_in", [0.02, 10], 2.0),
    "fleet.consumer_wait_ms": ("fleet", "slam.consume_wait", [0.05, 10],
                               5.0),
    "fleet.rebase_ms": ("fleet", "slam.rebase", [0.01, 2], 1.0),
    "live.prefetch_ms": ("live", "mapper.prefetch", [2.0, 100], 20.0),
    "live.extract_wait_ms": ("live", "extract.wait", [0.5, 200], 5.0),
    "live.ba_device_ms": ("live", "ba.replay_device", [1.5, 80], 15.0),
    "live.ba_captures": ("live", "ba.capture", [0.9, 3], 3.0),
}


def _rec(kind, timer):
    rec = {"kind": kind, "timer": dict(timer), "spans": {}}
    if kind == "fleet":
        rec.update(chunks=10, traced_chunks=2)
    else:
        rec.update(frames=100, traced_frames=4)
    # the program's top-level spans, present in any traced run of it
    rec["timer"].setdefault("slam.consume" if kind == "fleet"
                            else "session.add_frame", [1.0, 10])
    return rec


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_its_entry(name):
    kind, entry, value, want = READS[name]
    assert spec.reader(name)(_rec(kind, {entry: value})) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_without_the_program_spans_is_none(name):
    kind, entry, _, _ = READS[name]
    assert spec.reader(name)({"kind": kind, "timer": {}, "spans": {},
                              "chunks": 10, "frames": 100}) is None
    other = "live" if kind == "fleet" else "fleet"
    assert spec.reader(name)(_rec(other, {entry: [1.0, 1]})) is None


@pytest.mark.parametrize("name,entry", [("fleet.rebase_ms", "slam.rebase"),
                                        ("live.ba_captures", "ba.capture")])
def test_none_happened_reads_zero(name, entry):
    """No rebase (no closure accepted) and no bucket captured in a window
    of a program that has the spans: 0, not a missing metric."""
    kind = READS[name][0]
    assert spec.reader(name)(_rec(kind, {})) == 0.0


def test_stage_metrics_are_listed_for_their_cell():
    from conftest import ROOT

    man = spec.manifest(ROOT)
    layer = {m["name"]: m for m in man["per_layer"]}
    for name, (kind, _, _, _) in READS.items():
        m = layer[name]
        assert m["workloads"] == [f"euroc-mav.{kind}"]
        assert m["source"] in ("program_span", "program_counter")
