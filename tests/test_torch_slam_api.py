"""The port's public session API, ``slam_tpu_torch.pipeline.slam_api.Slam``,
on CPU: the JAX package's ``TestSlamApi`` cases (tests/test_api_and_viewer
.py, without the viewer) run on the port, the dual-map mode as
``TestFrontendBackendThreaded`` runs it (the backend thread issuing its
device work beside the frontend's), and a default session without a card
raising."""
import os

import numpy as np
import pytest
import torch

from torch_synthetic_world import (FakeOrbExtractor, TrackSimulator,
                                   make_mapper_input, make_world)
from slam_tpu_torch.geometry import se3
from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.mapper import Mapper
from slam_tpu_torch.pipeline.mapper_helpers import check_consistency
from slam_tpu_torch.pipeline.slam_api import Slam

torch.set_num_threads(1)


def _params(**overrides):
    base = dict(
        keyframeDecisionMinIntervalSeconds=0.0,
        keyframeDecisionCovisibilityRatio=0.95,
        minVisibleMapPointsInCurrentFrameBA=8,
        localBAProblemSize=12,
        adjacentSpaceSize=8,
        useFrontendSlam=False)
    base.update(overrides)
    return Parameters(slam=ParametersSlam(**base))


def _run_session(slam, world, n, tracker=None):
    tracker = tracker or TrackSimulator(world)
    futures = []
    for i in range(n):
        mi = make_mapper_input(world, i, tracker)
        futures.append(slam.add_frame(
            frame=mi.frame, pose_trail=mi.pose_trail,
            features_ids=mi.track_ids, features_pts=mi.track_pts,
            camera=mi.camera))
    return futures


class TestSlamApi:
    def test_synchronous_session(self, tmp_path):
        world = make_world(n_frames=12, n_landmarks=200)
        tracker = TrackSimulator(world)
        slam = Slam.build(_params(), orb_extractor=FakeOrbExtractor(world,
                                                                    tracker),
                          device="cpu")
        futures = _run_session(slam, world, 12, tracker)
        results = [f.result(timeout=60) for f in futures]
        assert all(r.pose_mat.shape == (4, 4) for r in results)
        assert any(len(r.point_cloud) > 0 for r in results)
        assert slam.end().result(timeout=60)

    def test_threaded_session(self):
        world = make_world(n_frames=12, n_landmarks=200)
        tracker = TrackSimulator(world)
        slam = Slam.build(_params(slamThread=True),
                          orb_extractor=FakeOrbExtractor(world, tracker),
                          device="cpu")
        futures = _run_session(slam, world, 12, tracker)
        results = [f.result(timeout=120) for f in futures]
        assert all(r.pose_mat.shape == (4, 4) for r in results)
        assert slam.end().result(timeout=120)

    def test_map_save_path(self, tmp_path):
        path = str(tmp_path / "m.npz")
        world = make_world(n_frames=10, n_landmarks=150)
        tracker = TrackSimulator(world)
        slam = Slam.build(_params(mapdbSavePath=path),
                          orb_extractor=FakeOrbExtractor(world, tracker),
                          device="cpu")
        _ = [f.result(timeout=60) for f in _run_session(slam, world, 10,
                                                        tracker)]
        assert slam.end().result(timeout=60)
        assert os.path.exists(path)

    def test_end_debug_callback(self):
        world = make_world(n_frames=8, n_landmarks=120)
        got = []
        tracker = TrackSimulator(world)
        slam = Slam.build(_params(pointCloudSavePath="x"),
                          orb_extractor=FakeOrbExtractor(world, tracker),
                          device="cpu")
        slam.connect_debug_api(end_debug_callback=lambda recs: got.append(recs))
        _ = [f.result(timeout=60) for f in _run_session(slam, world, 8,
                                                        tracker)]
        slam.end().result(timeout=60)
        assert len(got) == 1


def test_dual_map_mode_runs():
    world = make_world(n_frames=24, n_landmarks=250)
    tracker = TrackSimulator(world)
    mapper = Mapper(_params(useFrontendSlam=True, backendProcessDelay=2,
                            copySlamMapEveryNSlamFrames=4,
                            deterministicSlamMapCopy=True,
                            adjacentSpaceSize=10),
                    orb_extractor=FakeOrbExtractor(world, tracker),
                    device="cpu")
    poses = [mapper.advance(make_mapper_input(world, i, tracker))[0]
             for i in range(24)]
    assert mapper.end("")
    check_consistency(mapper.map_db)
    assert len(mapper.map_db.keyframes) >= 5
    errs = [np.linalg.norm(se3.camera_center(p)
                           - se3.camera_center(world.poses_cw[i]))
            for i, p in enumerate(poses)]
    assert np.median(errs) < 0.1


def test_a_default_session_without_a_card_raises():
    """No CPU fallback: without a card, a session built with the default
    device fails when it first puts work there."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    world = make_world(n_frames=4, n_landmarks=150)
    tracker = TrackSimulator(world)
    with pytest.raises((AssertionError, RuntimeError)):
        slam = Slam.build(_params(), orb_extractor=FakeOrbExtractor(world,
                                                                    tracker))
        for f in _run_session(slam, world, 4, tracker):
            f.result(timeout=60)
