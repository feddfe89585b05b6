"""The port's ``Mapper`` with ``pipelinedLocalBA`` (the local-BA solve
enqueued and collected at the next keyframe) against the JAX package's, on
CPU, on ``TestPipelinedLocalBA``'s world: the same keyframes and
map-point count, every frame's pose within 1e-4 m, and the same solve
still in flight at the end, which ``end()`` collects."""
import numpy as np
import torch

import synthetic_world as jworld
import torch_synthetic_world as tworld
from slam_tpu.geometry import se3 as jse3
from slam_tpu.params import Parameters as JParameters
from slam_tpu.params import ParametersSlam as JParametersSlam
from slam_tpu.pipeline.mapper import Mapper as JMapper
from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.mapper import Mapper
from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

torch.set_num_threads(1)
TOL = 1e-4


def _params(cls_params, cls_slam, **overrides):
    base = dict(keyframeDecisionMinIntervalSeconds=0.0,
                keyframeDecisionCovisibilityRatio=0.95,
                minVisibleMapPointsInCurrentFrameBA=8,
                localBAProblemSize=12, adjacentSpaceSize=10,
                useFrontendSlam=False)
    base.update(overrides)
    return cls_params(slam=cls_slam(**base))


def test_pipelined_local_ba_matches_jax():
    n = 25
    runs = []
    for mod, mapper_cls, params, kw in (
            (jworld, JMapper, _params(JParameters, JParametersSlam,
                                      pipelinedLocalBA=True), {}),
            (tworld, Mapper, _params(Parameters, ParametersSlam,
                                     pipelinedLocalBA=True),
             {"device": "cpu"})):
        world = mod.make_world(n_frames=n, n_landmarks=250, odom_noise=0.002)
        tracker = mod.TrackSimulator(world)
        mapper = mapper_cls(params, orb_extractor=mod.FakeOrbExtractor(
            world, tracker, pix_noise=0.3), **kw)
        poses = [mapper.advance(mod.make_mapper_input(world, i, tracker))[0]
                 for i in range(n)]
        in_flight = mapper.workspace_ba.pending is not None
        assert mapper.end("")
        runs.append((mapper, poses, in_flight))
    (jm, jposes, j_flight), (tm, tposes, t_flight) = runs
    assert t_flight == j_flight
    assert tm.workspace_ba.pending is None
    check_consistency(tm.map_db)
    assert sorted(tm.map_db.keyframes) == sorted(jm.map_db.keyframes)
    assert len(tm.map_db.keyframes) >= 5
    assert len(tm.map_db.map_points) == len(jm.map_db.map_points)
    for i, (a, b) in enumerate(zip(tposes, jposes)):
        assert np.linalg.norm(jse3.camera_center(a)
                              - jse3.camera_center(b)) < TOL, i
