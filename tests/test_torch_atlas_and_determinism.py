"""The reference's atlas relocation, deterministic reruns and large-map
scale tests (tests/test_atlas_and_determinism.py) on the port, on CPU:
``Mapper(device="cpu")`` over the port's copy of the synthetic world.
Reruns are bit-identical, as in the reference."""
import numpy as np
import pytest
import torch

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.ids import CURRENT_MAP_ID, MapId
from slam_tpu_torch.map.mapdb import LoopStage
from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.mapper import Mapper
from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

from torch_synthetic_world import (FakeOrbExtractor, TrackSimulator,
                             make_mapper_input, make_world)

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


def _run(world, params, n, tracker=None, extractor=None):
    tracker = tracker or TrackSimulator(world)
    extractor = extractor or FakeOrbExtractor(world, tracker)
    mapper = Mapper(params, orb_extractor=extractor, device="cpu")
    poses = []
    for i in range(n):
        pose, _ = mapper.advance(make_mapper_input(world, i, tracker))
        poses.append(pose)
    return mapper, poses


class TestAtlasRelocation:
    def test_relocation_stages_recorded(self, tmp_path):
        """Build a map, save it, reload as an atlas map, then revisit the
        same place: relocation must progress through the RELOCATION stages
        (reference: relocation.cpp:9-61 records stages only)."""
        map_path = str(tmp_path / "atlas0.npz")
        world = make_world(n_frames=30, n_landmarks=400, seed=8)
        mapper, _ = _run(world, _params(mapdbSavePath=map_path), 25)
        assert mapper.end("")

        # second session: same world, atlas loaded, relaxed gates so the
        # relocation RANSAC path gets exercised
        params2 = _params(mapdbLoadPath=[map_path],
                          minLoopClosureFeatureMatches=10,
                          loopClosureRansacMinInliers=8)
        tracker2 = TrackSimulator(world, seed=7)
        ex2 = FakeOrbExtractor(world, tracker2)
        mapper2 = Mapper(params2, orb_extractor=ex2, device="cpu")
        assert len(mapper2.atlas) == 1
        assert len(mapper2.atlas[0].keyframes) > 0
        for i in range(20):
            mapper2.advance(make_mapper_input(world, i, tracker2))
        stages = mapper2.map_db.loop_stages
        reloc = [s for k, s in stages.items() if k.map_id != CURRENT_MAP_ID]
        assert reloc, "no atlas candidates were considered"
        assert any(s in (LoopStage.RELOCATION_MAP_POINT_MATCHES,
                         LoopStage.RELOCATION_MAP_POINT_RANSAC)
                   for s in reloc), f"stages stuck at {reloc[:5]}"
        check_consistency(mapper2.map_db)


class TestDeterminism:
    def test_backend_only_reruns_identical(self):
        world = make_world(n_frames=20, n_landmarks=250, odom_noise=0.001)
        runs = []
        for _ in range(2):
            tracker = TrackSimulator(world)
            mapper, poses = _run(world, _params(), 20, tracker=tracker,
                                 extractor=FakeOrbExtractor(world, tracker))
            runs.append((poses, mapper))
        for p1, p2 in zip(runs[0][0], runs[1][0]):
            assert np.array_equal(p1, p2), "backend-only reruns must be bit-identical"
        db1, db2 = runs[0][1].map_db, runs[1][1].map_db
        assert set(db1.keyframes) == set(db2.keyframes)
        assert set(db1.map_points) == set(db2.map_points)

    def test_deterministic_dual_map_mode(self):
        """The lock-step map-copy handshake makes the threaded mode
        reproducible (reference: mapper.cpp:272-276, 399-403)."""
        world = make_world(n_frames=16, n_landmarks=250)
        runs = []
        for _ in range(2):
            tracker = TrackSimulator(world)
            params = _params(useFrontendSlam=True, backendProcessDelay=2,
                             copySlamMapEveryNSlamFrames=4,
                             deterministicSlamMapCopy=True)
            mapper, poses = _run(world, params, 16, tracker=tracker,
                                 extractor=FakeOrbExtractor(world, tracker))
            mapper.end("")
            runs.append(poses)
        for p1, p2 in zip(runs[0], runs[1]):
            assert np.array_equal(p1, p2), "lock-step runs must be bit-identical"


def test_global_ba_leaves_out_untriangulated_track_points(monkeypatch):
    """A track's map point waits at the origin until it is first
    triangulated; the port's global BA leaves it out (the JAX package's
    takes it, and on TestScale's world its f32 solve then moved every
    keyframe by up to 3 m)."""
    from slam_tpu_torch.map.map_point import MapPointStatus
    from slam_tpu_torch.pipeline import bundle_adjustment as tb

    world = make_world(n_frames=10, n_landmarks=250, odom_noise=0.001)
    mapper, _ = _run(world, _params(), 10)
    db = mapper.map_db
    pending = [mp for mp in db.map_points.values() if mp.observations
               and mp.status == MapPointStatus.NOT_TRIANGULATED]
    assert pending and all((mp.position == 0).all() for mp in pending)
    solved = []
    solve = tb._ProblemBuilder.solve

    def spy(builder, iterations, *pick):
        solved.append(list(builder.mp_ids))
        return solve(builder, iterations, *pick)
    monkeypatch.setattr(tb._ProblemBuilder, "solve", spy)
    tb.global_bundle_adjust(max(db.keyframes), db, mapper.settings,
                            device="cpu")
    assert len(solved) == 1 and len(solved[0]) > 100
    ids = {mp.id for mp in pending}
    assert not ids & set(solved[0])
    assert all((mp.position == 0).all() for mp in pending)
    check_consistency(db)
    errs = [np.linalg.norm(se3.camera_center(kf.pose_cw)
                           - se3.camera_center(world.poses_cw[int(kf.id)]))
            for kf in db.keyframes.values()]
    assert max(errs) < 0.05, errs


@pytest.mark.slow
class TestScale:
    def test_long_run_large_map(self):
        """Large-map behavior: sustained growth, bucket transitions, culling,
        consistency (the config-5 'large-scale mapping' analog)."""
        world = make_world(n_frames=150, n_landmarks=2500, trajectory="line",
                           odom_noise=0.001, seed=12)
        params = _params(adjacentSpaceSize=12, localBAProblemSize=16)
        tracker = TrackSimulator(world, max_tracks=60)
        mapper, _ = _run(world, params, 150, tracker=tracker,
                         extractor=FakeOrbExtractor(world, tracker))
        db = mapper.map_db
        # keyframe culling aggressively removes redundant keyframes
        # (keyframeCullMaxCriticalRatio) — the surviving set must still span
        # the whole trajectory and keep a healthy landmark count
        assert len(db.keyframes) >= 10, len(db.keyframes)
        assert int(max(db.keyframes)) - int(min(db.keyframes)) >= 120
        assert len(db.map_points) >= 500, len(db.map_points)
        check_consistency(db)
        # global BA over the whole map stays healthy
        from slam_tpu_torch.pipeline.bundle_adjustment import global_bundle_adjust
        global_bundle_adjust(max(db.keyframes), db, mapper.settings,
                             device="cpu")
        check_consistency(db)
        errs = [np.linalg.norm(se3.camera_center(kf.pose_cw)
                               - se3.camera_center(world.poses_cw[int(kf.id)]))
                for kf in db.keyframes.values()]
        assert np.median(errs) < 0.2, np.median(errs)

    def test_config5_scale_host_time_bounded(self):
        """Config-5 analog: grow the map to 500+ surviving keyframes with
        retrieval + loop closure enabled, and assert per-frame host time does
        NOT grow with map size (catches O(K^2) retrieval scans, linear
        neighbor walks, anything that creeps with K — reference bar:
        loop_closer.cpp:149 candidate-cap semantics keep per-frame cost flat
        at KITTI scale)."""
        import time as _time

        n_frames = 520
        # 20k landmarks: the surviving map must reach the >=20k-point regime
        # the round-3 KITTI run hit (RESULTS.md config 5) so the bound below
        # covers the scale where super-linear host stages actually bite
        world = make_world(n_frames=n_frames, n_landmarks=20000,
                           trajectory="line", odom_noise=0.001, seed=13)
        # every frame becomes a keyframe (covisibility gate disabled) and
        # culling is off: the synthetic line world has high inter-frame
        # overlap, so reference culling semantics would (correctly) collapse
        # the map — here we *want* K to reach config-5 scale to measure how
        # per-frame host cost grows with it
        params = _params(adjacentSpaceSize=6, localBAProblemSize=10,
                         keyframeDecisionCovisibilityRatio=1.0,
                         keyframeCullMaxCriticalRatio=0.0)
        tracker = TrackSimulator(world, max_tracks=60)
        extractor = FakeOrbExtractor(world, tracker)
        mapper = Mapper(params, orb_extractor=extractor, device="cpu")
        frame_ms = np.zeros(n_frames)
        for i in range(n_frames):
            t0 = _time.perf_counter()
            mapper.advance(make_mapper_input(world, i, tracker))
            frame_ms[i] = 1e3 * (_time.perf_counter() - t0)
        db = mapper.map_db
        assert len(db.keyframes) >= 500, len(db.keyframes)
        assert len(db.map_points) >= 20000, len(db.map_points)
        check_consistency(db)
        # warmup (compiles, first bucket transitions) lives in the first
        # quarter; steady state must not degrade as K quadruples and the
        # map crosses 20k points
        early = np.median(frame_ms[n_frames // 4: n_frames // 2])
        late = np.median(frame_ms[-n_frames // 4:])
        assert late < 2.5 * early, (early, late)
