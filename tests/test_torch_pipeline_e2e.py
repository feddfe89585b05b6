"""The reference's map serialization round trip
(tests/test_pipeline_e2e.py ``TestSerializationRoundTrip``) on the port,
on CPU: a ``Mapper(device="cpu")`` session's map saved and loaded with the
port's ``map/serialization``."""

import numpy as np
import torch

from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.mapper import Mapper
from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

from torch_synthetic_world import (FakeOrbExtractor, TrackSimulator, make_mapper_input,
                             make_world)

torch.set_num_threads(1)


def default_params(**overrides):
    base = dict(
        keyframeDecisionMinIntervalSeconds=0.0,
        keyframeDecisionCovisibilityRatio=0.95,
        minVisibleMapPointsInCurrentFrameBA=8,
        localBAProblemSize=12,
        adjacentSpaceSize=10,
        useFrontendSlam=False)
    base.update(overrides)
    return Parameters(slam=ParametersSlam(**base))


def run_sequence(world, params, n_frames=None, with_depth=False):
    tracker = TrackSimulator(world)
    extractor = FakeOrbExtractor(world, tracker)
    mapper = Mapper(params, orb_extractor=extractor, device="cpu")
    poses = []
    for i in range(n_frames or len(world.poses_cw)):
        mi = make_mapper_input(world, i, tracker, with_depth=with_depth)
        pose, cloud = mapper.advance(mi)
        poses.append(pose)
    return mapper, poses, tracker


class TestSerializationRoundTrip:
    def test_save_load(self, tmp_path):
        from slam_tpu_torch.map.serialization import load_map_db, save_map_db
        world = make_world(n_frames=20, n_landmarks=200)
        mapper, _, tracker = run_sequence(world, default_params())
        path = str(tmp_path / "map.npz")
        save_map_db(mapper.map_db, path)
        db2 = load_map_db(None, None, path)
        assert set(db2.keyframes) == set(mapper.map_db.keyframes)
        assert set(db2.map_points) == set(mapper.map_db.map_points)
        for kf_id, kf in mapper.map_db.keyframes.items():
            kf2 = db2.keyframes[kf_id]
            assert np.allclose(kf2.pose_cw, kf.pose_cw)
            assert np.array_equal(kf2.shared.descriptors, kf.shared.descriptors)
            assert np.array_equal(kf2.map_points, kf.map_points)
            assert kf2.shared.feature_search is not None
        for mp_id, mp in mapper.map_db.map_points.items():
            mp2 = db2.map_points[mp_id]
            assert np.allclose(mp2.position, mp.position)
            assert mp2.observations == mp.observations
            assert mp2.status == mp.status
        check_consistency(db2)

    def test_trajectory_csv(self, tmp_path):
        from slam_tpu_torch.map.serialization import save_trajectory_csv
        world = make_world(n_frames=12)
        mapper, _, tracker = run_sequence(world, default_params())
        path = str(tmp_path / "traj.csv")
        save_trajectory_csv(mapper.map_db, path)
        lines = open(path).read().strip().splitlines()
        assert len(lines) == len(mapper.map_db.keyframes)
        row = [float(v) for v in lines[0].split(",")]
        assert len(row) == 8  # t, xyz, quat
