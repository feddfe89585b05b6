"""Whole-session parity of the port's ``Mapper`` with the JAX package's on
CPU, on ``TestBackendOnlyVO``'s straight-line world (tests/test_pipeline_e2e
.py: 30 frames, 300 landmarks, exact odometry) with the same fake
extractor: the same keyframe ids and map-point count, every frame's pose
within 1e-4 m and 1e-4 in its rotation entries, and every bundle-adjustment
problem the two builders pad (pose-only and two-stage local BA) with the
same padded sizes, equal integer arrays and float arrays within 1e-4. The
session runs on the BoW device branch (CPU tensors) at the 65,536-word
vocabulary."""
import numpy as np
import pytest
import torch

import synthetic_world as jworld
import torch_synthetic_world as tworld
from slam_tpu.geometry import se3 as jse3
from slam_tpu.params import Parameters as JParameters
from slam_tpu.params import ParametersSlam as JParametersSlam
from slam_tpu.pipeline import bundle_adjustment as jbundle
from slam_tpu.pipeline.mapper import Mapper as JMapper
from slam_tpu_torch.ops import bow as tbow
from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline import bundle_adjustment as tbundle
from slam_tpu_torch.pipeline.mapper import Mapper
from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

torch.set_num_threads(1)
N_FRAMES = 30
TOL = 1e-4
PARAMS = dict(keyframeDecisionMinIntervalSeconds=0.0,
              keyframeDecisionCovisibilityRatio=0.95,
              minVisibleMapPointsInCurrentFrameBA=8,
              localBAProblemSize=12, adjacentSpaceSize=10,
              useFrontendSlam=False)


def _run(world_mod, mapper_cls, params, builder_cls, **kw):
    """One session; records every problem the BA builder pads."""
    built = []
    original = builder_cls.build

    def build(self):
        problem = original(self)
        built.append(problem)
        return problem

    builder_cls.build = build
    try:
        world = world_mod.make_world(n_frames=N_FRAMES, n_landmarks=300,
                                     odom_noise=0.0)
        tracker = world_mod.TrackSimulator(world)
        mapper = mapper_cls(params, orb_extractor=world_mod.FakeOrbExtractor(
            world, tracker), **kw)
        poses = [mapper.advance(world_mod.make_mapper_input(
            world, i, tracker))[0] for i in range(N_FRAMES)]
    finally:
        builder_cls.build = original
    return world, mapper, poses, built


@pytest.fixture(scope="module")
def sessions():
    device_calls = tbow.quantize.device_calls
    jax_run = _run(jworld, JMapper,
                   JParameters(slam=JParametersSlam(**PARAMS)),
                   jbundle._ProblemBuilder)
    port_run = _run(tworld, Mapper, Parameters(slam=ParametersSlam(**PARAMS)),
                    tbundle._ProblemBuilder, device="cpu")
    return jax_run, port_run, tbow.quantize.device_calls - device_calls


def test_same_keyframes_poses_and_map_points(sessions):
    (_, jm, jposes, _), (world, tm, tposes, _), _ = sessions
    assert sorted(tm.map_db.keyframes) == sorted(jm.map_db.keyframes)
    assert len(tm.map_db.keyframes) >= 5
    assert len(tm.map_db.map_points) == len(jm.map_db.map_points)
    for i, (a, b) in enumerate(zip(tposes, jposes)):
        assert np.linalg.norm(jse3.camera_center(a)
                              - jse3.camera_center(b)) < TOL, i
        np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=TOL)
    for k, kf in tm.map_db.keyframes.items():
        np.testing.assert_allclose(kf.pose_cw, jm.map_db.keyframes[k].pose_cw,
                                   atol=TOL)


def test_session_is_consistent_and_tracks_ground_truth(sessions):
    _, (world, tm, tposes, _), device_calls = sessions
    check_consistency(tm.map_db)
    errs = [np.linalg.norm(jse3.camera_center(p)
                           - jse3.camera_center(world.poses_cw[i]))
            for i, p in enumerate(tposes)]
    assert np.median(errs) < 0.05, np.median(errs)
    # every keyframe's words came from the device branch (n * 65536 is
    # above the size threshold for the fake extractor's keypoint counts)
    assert device_calls >= len(tm.map_db.keyframes)
    assert tm.workspace_ba.device == torch.device("cpu")


def test_builders_pad_the_same_problems(sessions):
    (_, _, _, jbuilt), (_, _, _, tbuilt), _ = sessions
    assert len(tbuilt) == len(jbuilt) >= 10
    sizes = set()
    for i, (t, j) in enumerate(zip(tbuilt, jbuilt)):
        for name, a, b in zip(t._fields, t, j):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (i, name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, atol=TOL,
                                           err_msg=f"{i} {name}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{i} {name}")
        sizes.add((t.poses.shape[0], t.points.shape[0], t.obs_kf.shape[0],
                   t.pe_a.shape[0], t.pr_idx.shape[0]))
    # the reference's quanta: K 16, M 256, O 1024, E 32, P 1
    for K, M, O, E, P in sizes:
        assert K % 16 == 0 and M % 256 == 0 and O % 1024 == 0
        assert E % 32 == 0 and P >= 1
    # the first problem is built from identical maps: bit-equal
    for a, b in zip(tbuilt[0], jbuilt[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
