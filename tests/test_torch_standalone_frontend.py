"""The port's standalone descriptor tracker and PNG renders: the
reference's ``TestDescriptorTracker`` and ``TestViz2d``
(tests/test_standalone_frontend.py) on the port's own extractor on CPU, and
the port's tracker beside the JAX package's on shared front-end results
(the JAX extractor's, converted), where the track ids must be equal frame
by frame. The extractor's words do not reach the tracker, so its tests
quantize against a 512-word codebook."""
import dataclasses

import numpy as np
import pytest
import torch

from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker
from slam_tpu_torch.ops.frontend import FrontendResult
from slam_tpu_torch.params import Parameters, ParametersSlam, StaticSettings
from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                            render_frame)

torch.set_num_threads(1)


def _rendered_sequence(n=4, seed=0):
    """``bench.render_world``'s world and frames, through the port."""
    world = make_world(n_frames=n, n_landmarks=300, seed=seed,
                       trajectory="line", camera=default_camera(640, 480))
    patches = np.random.default_rng(seed + 1).integers(
        40, 255, (300, 11, 11)).astype(np.uint8)
    return [render_frame(world, patches, i, 640, 480) for i in range(n)]


@pytest.fixture(scope="module")
def frames():
    return _rendered_sequence(4)


def _settings(max_keypoints):
    return StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=max_keypoints, bowVocabularySize=512)))


class TestDescriptorTracker:
    def test_tracks_persist_across_frames(self, frames):
        tracker = DescriptorTracker(_settings(400), 640, 480, device="cpu")
        t0 = tracker.process(frames[0])
        t1 = tracker.process(frames[1])
        assert len(t0.tracked_id_list) > 30
        carried = set(t0.tracked_id_list.tolist()) & set(t1.tracked_id_list.tolist())
        assert len(carried) > 15, f"only {len(carried)} tracks persisted"
        # track positions move smoothly (scene shifts ~0.12m between frames)
        common = sorted(carried)[:10]
        for tid in common:
            p0 = t0.tracked_pts[list(t0.tracked_id_list).index(tid)]
            p1 = t1.tracked_pts[list(t1.tracked_id_list).index(tid)]
            assert np.linalg.norm(p1 - p0) < 80.0

    def test_fresh_ids_monotonic(self, frames):
        tracker = DescriptorTracker(_settings(300), 640, 480, device="cpu")
        seen = set()
        for f in frames:
            tf = tracker.process(f)
            ids = tf.tracked_id_list.tolist()
            assert len(ids) == len(set(ids))  # unique within a frame
            seen.update(ids)
        assert tracker._next_id == max(seen) + 1
        assert tracker.extractor.extractions == len(frames)


class _Replay:
    """An extractor stand-in that returns recorded results in turn."""

    def __init__(self, results):
        self._results = list(results)

    def detect_and_extract(self, image, *args, **kw):
        return self._results.pop(0)


def test_track_ids_match_jax_on_shared_features(frames):
    from slam_tpu.frontends.descriptor_tracker import \
        DescriptorTracker as JTracker
    from slam_tpu.ops.frontend import OrbExtractor as JExtractor
    from slam_tpu.params import Parameters as JParameters
    from slam_tpu.params import ParametersSlam as JParametersSlam
    from slam_tpu.params import StaticSettings as JStaticSettings

    jsettings = JStaticSettings(JParameters(slam=JParametersSlam(
        maxKeypoints=400, bowVocabularySize=512)))
    jres = [JExtractor(jsettings, 640, 480, max_tracked=128)
            .detect_and_extract(f) for f in frames]
    tres = [FrontendResult(**{k: (None if v is None else np.copy(v))
                              for k, v in dataclasses.asdict(r).items()})
            for r in jres]
    jt = JTracker.__new__(JTracker)
    jt.__dict__.update(max_tracks=128, match_threshold=50, lowe_ratio=0.8,
                       max_motion_px=80.0, _next_id=0, _prev=None,
                       _prev_track_ids=None, extractor=_Replay(jres))
    tt = DescriptorTracker.__new__(DescriptorTracker)
    tt.__dict__.update(max_tracks=128, match_threshold=50, lowe_ratio=0.8,
                       max_motion_px=80.0, _next_id=0, _prev=None,
                       _prev_track_ids=None, extractor=_Replay(tres))
    carried = 0
    prev = None
    for f in frames:
        a, b = jt.process(f), tt.process(f)
        np.testing.assert_array_equal(b.track_ids, a.track_ids)
        np.testing.assert_array_equal(b.tracked_id_list, a.tracked_id_list)
        np.testing.assert_array_equal(b.tracked_pts, a.tracked_pts)
        if prev is not None:
            carried += len(set(prev) & set(b.tracked_id_list.tolist()))
        prev = b.tracked_id_list.tolist()
    assert carried > 45 and tt._next_id == jt._next_id


def test_numpy_matcher_equals_native():
    """The tracker's NumPy twin and the native matcher agree on clustered
    keypoints (the reference's test_match_tracker_matches_numpy_twin)."""
    from slam_tpu_torch import native

    tr = DescriptorTracker.__new__(DescriptorTracker)
    tr.match_threshold = 60
    tr.lowe_ratio = 0.9
    tr.max_motion_px = 12.0
    for trial in range(5):
        r = np.random.default_rng(100 + trial)
        n1, n2 = int(r.integers(1, 80)), int(r.integers(1, 80))
        pts2 = r.uniform(0, 60, (n2, 2)).astype(np.float32)
        pts1 = (pts2[r.integers(0, n2, n1)]
                + r.normal(0, 8, (n1, 2))).astype(np.float32)
        base = r.integers(0, 2**32, (max(n1, n2), 8), dtype=np.uint32)
        d2 = base[:n2].copy()
        d1 = base[r.integers(0, n2, n1)].copy()
        got = native.match_tracker(d1, pts1, d2, pts2, tr.max_motion_px,
                                   tr.match_threshold, tr.lowe_ratio)
        want = tr._match_to_prev_numpy(d1, pts1, d2, pts2)
        np.testing.assert_array_equal(got, want)


class TestViz2d:
    def test_png_roundtrip(self, tmp_path):
        from slam_tpu_torch.utils.viz2d import write_png
        img = np.random.default_rng(0).integers(0, 255, (32, 48, 3)).astype(np.uint8)
        path = str(tmp_path / "t.png")
        write_png(path, img)
        from PIL import Image
        back = np.asarray(Image.open(path))
        assert np.array_equal(back, img)

    def test_overlays_and_map_render(self, tmp_path):
        from slam_tpu_torch.utils.viz2d import PngDebugPublisher
        from torch_synthetic_world import (FakeOrbExtractor, TrackSimulator,
                                           make_mapper_input, make_world)
        from slam_tpu_torch.pipeline.mapper import Mapper
        world = make_world(n_frames=8, n_landmarks=150)
        tracker = TrackSimulator(world)
        mapper = Mapper(Parameters(slam=ParametersSlam(
            useFrontendSlam=False, minVisibleMapPointsInCurrentFrameBA=8,
            localBAProblemSize=12)),
            orb_extractor=FakeOrbExtractor(world, tracker), device="cpu")
        for i in range(8):
            mapper.advance(make_mapper_input(world, i, tracker))
        pub = PngDebugPublisher(str(tmp_path))
        kf = mapper.map_db.latest_keyframe()
        img = np.zeros((480, 640), np.uint8)
        p1 = pub.visualize_keyframe(mapper.map_db, img, kf)
        p2 = pub.visualize_orbs(img, kf)
        p3 = pub.visualize_map(mapper.map_db)
        for p in (p1, p2, p3):
            import os
            assert os.path.exists(p) and os.path.getsize(p) > 100
