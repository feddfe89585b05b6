"""The port's interactive loop closure beside the JAX package's, on CPU, on
``TestLoopClosure``'s world (tests/test_loop_closure.py: a square loop of
60 frames walked 74 frames with odometry drift, the fallback gates of that
test). ``jax.random`` streams cannot be reproduced, so the port's RANSAC
sampler is fed the JAX package's hypothesis bank for each solve.

The two sessions run in lockstep until frame 33, and the test holds them
to it frame by frame: the same keyframe ids, camera centres within 5e-5 m
(f32 LM solves in two orders of summation; the widest gap before frame
33 is 1.2e-5 m). At frame 33 a local BA meets points seen from one
keyframe only: their 3x3 normal blocks are singular in f32 (condition up
to 2e9: the damping 1e-4, their smallest eigenvalue, is below one ulp of
their largest entry), and
the third LU pivot rounds to 0 in the JAX package's LAPACK and to -1.7e-4
in torch's, so the JAX solve gets NaN and rejects its first LM step while
the port takes it (ROADMAP section 3). From there the maps differ by a
few map points and each package closes its own loop: the JAX package
(10, 70), the port (3, 63). For the rest of the session the test holds the
port to what both must do: one closure, a lap apart, a consistent map and
a final pose near the truth, and the port's viewer modules render and
export the closure. Slow: about ninety seconds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_world as jworld
import torch_synthetic_world as tworld
from slam_tpu.geometry import se3 as jse3
from slam_tpu.params import Parameters as JParameters
from slam_tpu.params import ParametersSlam as JParametersSlam
from slam_tpu.pipeline.mapper import Mapper as JMapper
from slam_tpu_torch.ops import ransac as transac
from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.mapper import Mapper
from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

torch.set_num_threads(1)
LOOP = dict(keyframeDecisionMinIntervalSeconds=0.0,
            keyframeDecisionCovisibilityRatio=0.95,
            minVisibleMapPointsInCurrentFrameBA=8, localBAProblemSize=12,
            adjacentSpaceSize=8, useFrontendSlam=False,
            minLoopClosureFeatureMatches=15, loopClosureRansacMinInliers=12,
            loopClosureRansacIterations=100)


def _jax_bank(valid, iterations, seed):
    """The hypothesis bank of the JAX package's ``_sim3_ransac_impl``."""
    valid = valid.cpu().numpy()
    keys = jax.random.split(jax.random.PRNGKey(np.uint32(seed)), iterations)
    p = jnp.asarray(valid, jnp.float32)
    pick = lambda k: jax.random.choice(k, len(valid), shape=(3,),
                                       replace=False, p=p / jnp.sum(p))
    return torch.from_numpy(np.asarray(jax.vmap(pick)(keys)).astype(np.int64))


LOCKSTEP_FRAMES = 33  # frames 0-32, before the singular block of frame 33


def _session(mod, mapper_cls, params, n_frames, world_kw, **kw):
    """The session's world and mapper, and after each of the first
    ``LOCKSTEP_FRAMES`` frames the camera centre of every keyframe."""
    world = mod.make_world(n_frames=n_frames, **world_kw)
    tracker = mod.TrackSimulator(world, max_tracks=50)
    mapper = mapper_cls(params, orb_extractor=mod.FakeOrbExtractor(
        world, tracker), **kw)
    centres = []
    for i in range(n_frames):
        mapper.advance(mod.make_mapper_input(world, i, tracker))
        if i < LOCKSTEP_FRAMES:
            centres.append({int(k): jse3.camera_center(kf.pose_cw)
                            for k, kf in mapper.map_db.keyframes.items()})
    return world, mapper, centres


@pytest.mark.slow
class TestLoopClosure:
    def test_closes_like_jax(self, monkeypatch):
        per_side = 15
        lap = 4 * per_side
        n_frames = lap + 14
        world_kw = dict(n_landmarks=500, trajectory="loop", odom_drift=0.003,
                        seed=4, lap_frames=lap)
        _, jm, jcentres = _session(jworld, JMapper,
                                   JParameters(slam=JParametersSlam(**LOOP)),
                                   n_frames, world_kw)
        monkeypatch.setattr(transac, "sample_hypotheses", _jax_bank)
        world, tm, tcentres = _session(tworld, Mapper,
                                       Parameters(slam=ParametersSlam(**LOOP)),
                                       n_frames, world_kw, device="cpu")
        # lockstep: the same keyframes, camera centres within 5e-5 m
        assert len(tcentres) == len(jcentres) == LOCKSTEP_FRAMES
        for i, (t, j) in enumerate(zip(tcentres, jcentres)):
            assert sorted(t) == sorted(j), (i, sorted(t), sorted(j))
            err = max(np.linalg.norm(t[k] - j[k]) for k in t)
            assert err < 5e-5, (i, err)
        check_consistency(tm.map_db)
        edges = [(int(e.kf_id1), int(e.kf_id2))
                 for e in tm.map_db.loop_closure_edges]
        jedges = [(int(e.kf_id1), int(e.kf_id2))
                  for e in jm.map_db.loop_closure_edges]
        assert len(edges) == len(jedges) >= 1, (edges, jedges)
        for a, b in edges + jedges:           # each pairs a place a lap on
            assert abs(b - a - lap) <= 4, (edges, jedges)
        final = tm.map_db.latest_keyframe()
        err = np.linalg.norm(jse3.camera_center(final.pose_cw)
                             - jse3.camera_center(
                                 world.poses_cw[int(final.id)]))
        assert err < 0.2, err

        # the viewer's view of the closed loop (tests/test_loop_closure.py
        # :125-139): the orthographic render shows the closure edge, and
        # the JSON export carries it
        import json
        import tempfile

        from slam_tpu_torch.utils import viz2d
        from slam_tpu_torch.utils.viewer import ViewerDataPublisher

        img = viz2d.render_map_orthographic(tm.map_db)
        lc = np.array(viz2d.COLOR_LOOP_EDGE, np.uint8)
        assert (img == lc).all(axis=-1).any(), \
            "loop-closure edge color not present in the map render"
        with tempfile.TemporaryDirectory() as d:
            viz2d.write_png(f"{d}/loop_map.png", img)
            pub = ViewerDataPublisher()
            pub.publish_map(tm.map_db, None, ParametersSlam(**LOOP))
            pub.dump_json(f"{d}/map.json")
            with open(f"{d}/map.json") as f:
                exported = json.load(f)
            assert len(exported["loopClosureEdges"]) >= 1
        assert tm.end("")

    def test_no_false_loop_on_line(self):
        world_kw = dict(n_landmarks=300, trajectory="line")
        _, tm, _ = _session(tworld, Mapper,
                            Parameters(slam=ParametersSlam(**LOOP)), 30,
                            world_kw, device="cpu")
        assert len(tm.map_db.loop_closure_edges) == 0
