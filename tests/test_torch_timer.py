"""The port's span recorder (``slam_tpu_torch/utils/timer.py``) and where
the program opens its spans, on the CPU.

Spans nest per thread: a span's parent is the innermost span open on its
own thread, and its self time is its duration less what its children
cover. Each span is a ``torch.profiler.record_function`` of its name while
timing is on. Counters and durations measured elsewhere land in ``totals``
and ``counts``, the two dicts the benchmark reads. While timing is off,
``section`` is a ``contextlib.nullcontext`` and nothing is recorded: a
``DeviceSlam`` chunk, an ``OrbExtractor`` prefetch and a ``Mapper``
session then open no ``record_function`` and make no CUDA timing event.
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from slam_tpu_torch.utils import timer

torch.set_num_threads(1)


@pytest.fixture
def stats():
    st = timer.enable_timing()
    yield st
    timer.disable_timing()


def _by_name(st):
    return {s.name: s for s in st.spans}


def test_spans_nest_per_thread(stats):
    """Two threads, each with a span inside a span, opened at once: each
    inner span's parent is its own thread's outer span."""
    barrier = threading.Barrier(2)

    def work(tag):
        with timer.section(f"outer.{tag}"):
            barrier.wait()
            with timer.section(f"inner.{tag}"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = _by_name(stats)
    assert len(stats.spans) == 4
    for tag in "ab":
        outer, inner = spans[f"outer.{tag}"], spans[f"inner.{tag}"]
        assert outer.parent == -1 and inner.parent == outer.id
        assert inner.thread == outer.thread
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    assert spans["outer.a"].thread != spans["outer.b"].thread


def test_self_time_is_duration_less_children(stats):
    with timer.section("parent"):
        time.sleep(0.01)
        for _ in range(2):
            with timer.section("child"):
                time.sleep(0.005)
                with timer.section("grandchild"):
                    time.sleep(0.002)
    spans = stats.spans
    parent = next(s for s in spans if s.name == "parent")
    children = [s for s in spans if s.parent == parent.id]
    assert [s.name for s in children] == ["child", "child"]
    cover = sum(s.end_ns - s.start_ns for s in children)
    dur = parent.end_ns - parent.start_ns
    assert stats.self_totals["parent"] == pytest.approx((dur - cover) * 1e-9,
                                                        abs=1e-12)
    assert stats.totals["parent"] == pytest.approx(dur * 1e-9, abs=1e-12)
    assert stats.self_totals["parent"] >= 0.01
    grand = sum(s.end_ns - s.start_ns for s in spans
                if s.name == "grandchild") * 1e-9
    assert stats.self_totals["child"] == pytest.approx(
        stats.totals["child"] - grand, abs=1e-9)
    assert stats.counts == {"parent": 1, "child": 2, "grandchild": 2}


def test_timed_is_a_span_under_the_function_name(stats):
    @timer.timed
    def work(x):
        with timer.section("inside"):
            return x + 1

    assert work(1) == 2
    spans = _by_name(stats)
    assert spans["inside"].parent == spans["work"].id


@pytest.mark.parametrize("kind", ["count", "add", "add_device"])
def test_counters_and_durations_land_in_totals_and_counts(stats, kind):
    """What ``benchmark/run.py`` hands its readers: ``{name: [total,
    count]}`` for every key of ``totals``."""
    if kind == "count":
        timer.count("things", 3)
        timer.count("things")
        want = [0.0, 4]
    else:
        getattr(timer, kind)("things", 0.25)
        getattr(timer, kind)("things", 0.5)
        want = [0.75, 2]
    rec = {k: [stats.totals[k], stats.counts[k]] for k in stats.totals}
    assert rec == {"things": want}
    assert stats.spans == [] and "things" not in stats.self_totals
    assert ("things" in stats.device) == (kind == "add_device")
    row = stats.table().splitlines()[1].split()
    assert row[0] == "things" and row[2] == str(want[1])
    assert row[-1] == {"count": "-", "add": "-",
                       "add_device": "device"}[kind]


def test_spans_are_profiler_annotations(stats, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with timer.section("a"):
        with timer.section("b"):
            pass
    assert opened == ["a", "b"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.section("in.trace"):
            torch.ones(4).sum()
    assert any(e.name == "in.trace" for e in prof.events())


def test_reset_clears_everything(stats):
    with timer.section("a"):
        timer.count("n")
        timer.add_device("d", 1.0)
    stats.reset()
    assert not (stats.totals or stats.counts or stats.self_totals
                or stats.device or stats.spans)


def test_off_is_a_nullcontext_and_records_nothing(monkeypatch):
    timer.disable_timing()
    assert isinstance(timer.section("x"), contextlib.nullcontext)
    _forbid_instruments(monkeypatch)

    @timer.timed
    def work():
        with timer.section("y"):
            timer.count("n")
            timer.add("h", 1.0)
            timer.add_device("d", 1.0)
        return 5

    assert work() == 5
    assert timer.TIME_STATS is None


def _forbid_instruments(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("instrumented while timing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)


# ---------------------------------------------------------------------------
# the program's spans


W, H = 160, 120


def _frame(seed=31):
    from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                                render_frame)

    world = make_world(n_frames=1, n_landmarks=300, seed=seed,
                       trajectory="loop", lap_frames=64,
                       camera=default_camera(W, H))
    patches = np.random.default_rng(seed).integers(
        40, 255, (300, 11, 11)).astype(np.uint8)
    return render_frame(world, patches, 0, W, H)


def _params(**kw):
    from slam_tpu_torch.params import Parameters, ParametersSlam

    return Parameters(slam=ParametersSlam(
        useFrontendSlam=False, keyframeDecisionMinIntervalSeconds=0.0,
        minVisibleMapPointsInCurrentFrameBA=8, localBAProblemSize=12,
        adjacentSpaceSize=8, **kw))


def _mapper():
    """A Mapper whose extractor, built at the first frame, keeps 150
    keypoints and skips the words (no vocabulary)."""
    from slam_tpu_torch.pipeline.mapper import Mapper

    return Mapper(_params(maxKeypoints=150, bowVocabularySize=0),
                  device="cpu")


def _prefetch_and_collect(mapper, frame):
    from slam_tpu_torch.map.keyframe import MapperInput, Pose

    mi = MapperInput(frame=frame, camera=None,
                     track_ids=np.array([7, 8]),
                     track_pts=np.array([[10.0, 10.0], [50.0, 60.0]],
                                        np.float32),
                     track_depths=None,
                     pose_trail=[Pose(frame_number=3, t=0.15,
                                      pose_cw=np.eye(4))], t=0.15)
    mapper.prefetch(mi)
    return mapper._orb_extractor.detect_and_extract(frame, key=3)


def test_prefetch_spans_the_extractors_host_work(stats):
    """``Mapper.prefetch`` holds ``extract.enqueue``, which holds the
    tracked points' pack, the image's upload, the extraction and the
    words; collecting it is ``detect_and_extract``, and the extraction is
    counted."""
    res = _prefetch_and_collect(_mapper(), _frame())
    assert res.valid.any()
    spans = _by_name(stats)
    enq = spans["extract.enqueue"]
    assert enq.parent == spans["mapper.prefetch"].id
    kids = [s.name for s in stats.spans if s.parent == enq.id]
    assert kids == ["extract.pack", "extract.upload", "extract.extract",
                    "extract.words"]
    assert spans["detect_and_extract"].parent == -1
    assert stats.counts["extract.extraction"] == 1


@pytest.fixture(scope="module")
def world():
    from torch_synthetic_world import TrackSimulator, make_world

    w = make_world(n_frames=12, n_landmarks=300, seed=3)
    return w, TrackSimulator(w)


def _session(world, frames=12):
    from slam_tpu_torch.pipeline.slam_api import Slam
    from torch_synthetic_world import FakeOrbExtractor, make_mapper_input

    w, tracker = world
    slam = Slam(_params(), orb_extractor=FakeOrbExtractor(w, tracker),
                device="cpu")
    for i in range(frames):
        mi = make_mapper_input(w, i, tracker)
        slam.add_frame(mi.frame, mi.pose_trail, mi.track_ids, mi.track_pts,
                       camera=mi.camera).result()
    return slam


def test_session_spans_nest_under_the_submitted_frame(stats, world):
    """Each ``Slam.add_frame`` (no worker thread) is ``session.add_frame``,
    whose child is ``mapper.add_frame``; the Mapper's stages, the local BA
    among them, are its descendants, and the BA's own sections nest in
    ``local_bundle_adjust``."""
    _session(world)
    spans = {s.id: s for s in stats.spans}
    top = [s for s in stats.spans if s.parent == -1]
    assert {s.name for s in top} == {"session.add_frame"}
    assert stats.counts["session.add_frame"] == 12
    for s in stats.spans:
        if s.name == "mapper.add_frame":
            assert spans[s.parent].name == "session.add_frame"
    names = {s.name for s in stats.spans}
    assert {"match_tracked_features", "local_bundle_adjust",
            "ba_build"} <= names

    def ancestors(s):
        while s.parent != -1:
            s = spans[s.parent]
            yield s.name

    for s in stats.spans:
        if s.name.startswith("ba_") and s.name != "ba_collect_deferred":
            assert "local_bundle_adjust" in ancestors(s), s.name
        if s.name not in ("session.add_frame", "mapper.add_frame"):
            assert "mapper.add_frame" in ancestors(s), s.name
    assert stats.counts["ba.eager"] > 0


def test_timing_off_opens_nothing_in_the_program(monkeypatch, world):
    """No ``record_function`` and no CUDA timing event anywhere on the
    interactive path (prefetch, extraction, a session with its BAs) or the
    serving path (a ``DeviceSlam`` chunk), and nothing recorded."""
    from slam_tpu_torch.pipeline import device_vo as tvo
    from slam_tpu_torch.pipeline.device_slam import DeviceSlam

    timer.disable_timing()
    frame = _frame()
    cfg = tvo.DeviceVOConfig(width=W, height=H, lm_capacity=64,
                             max_keypoints=100, window=2, window_ba_every=2,
                             loop_every=2, loop_slots=4, loop_words=32,
                             loop_min_gap=2, loop_points=8)
    ds = DeviceSlam(cfg, batch=1, device="cpu")
    _forbid_instruments(monkeypatch)
    assert _prefetch_and_collect(_mapper(), frame).valid.any()
    _session(world, frames=4)
    images = np.stack([frame, frame])[None]
    ds.advance(images, np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1)))
    ds.finish()
    assert timer.TIME_STATS is None
    # the chunk's stamps are written whether timing is on or off
    assert (ds.vo.last_stamps > 0).all()
