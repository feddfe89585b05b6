"""The reference's viewer publisher and command queue tests
(tests/test_api_and_viewer.py ``TestViewerPublisher``, ``TestCommandQueue``)
on the port, on CPU: the port's ``Slam.connect_debug_api`` feeding the
port's ``utils/viewer.ViewerDataPublisher``, and its ``utils/viz2d``
renders."""
import numpy as np
import torch

from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.slam_api import Slam
from slam_tpu_torch.utils.commands import CommandQueue, StepMode, step_wait
from slam_tpu_torch.utils.viewer import ViewerDataPublisher, ViewerParameters

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


class TestViewerPublisher:
    def test_snapshots_and_json(self, tmp_path):
        world = make_world(n_frames=10, n_landmarks=200)
        pub = ViewerDataPublisher()
        tracker = TrackSimulator(world)
        slam = Slam.build(_params(), orb_extractor=FakeOrbExtractor(world, tracker),
                          device="cpu")
        slam.connect_debug_api(viewer_publisher=pub)
        _ = [f.result(timeout=60) for f in _run_session(slam, world, 10, tracker)]
        kfs = pub.get_keyframes()
        mps = pub.get_map_points()
        assert len(kfs) > 0 and len(mps) > 0
        assert any(k["current"] for k in kfs)
        path = str(tmp_path / "viz.json")
        pub.dump_json(path)
        import json
        snap = json.load(open(path))
        assert len(snap["keyframes"]) == len(kfs)

        # contract with the interactive HTML viewer (tools/slam_viewer.html,
        # the Pangolin-viewer equivalent): every data field its renderer
        # reads must exist in the exported snapshot
        for key in ("mapPoints", "keyframes", "loopStages",
                    "loopClosureEdges", "atlas"):
            assert key in snap
        kf0 = snap["keyframes"][0]
        for key in ("id", "poseWC", "origPoseWC", "neighbors", "current",
                    "localMap", "stereoPointCloud"):
            assert key in kf0
        mp0 = snap["mapPoints"][0]
        for key in ("position", "status", "localMap", "nowVisible", "color"):
            assert key in mp0
        import os
        html = open(os.path.join(os.path.dirname(__file__), "..", "tools",
                                 "slam_viewer.html")).read()
        for field in ("mapPoints", "keyframes", "loopStages",
                      "loopClosureEdges", "atlas", "poseWC", "origPoseWC",
                      "neighbors", "stereoPointCloud", "nowVisible"):
            assert field in html
        slam.end().result(timeout=60)

    def test_atlas_overlay_render(self, tmp_path):
        """Atlas maps render alongside the current map with the reference's
        two-row auto layout and per-map alignment controls
        (slam_viewer.cpp:122-161, 287-310, 421-428), and relocation stages
        recorded against an atlas keyframe highlight that keyframe, not a
        same-id current-map one."""
        from slam_tpu_torch.ids import KfId, MapId
        from slam_tpu_torch.map.mapdb import LoopStage, MapKf
        from slam_tpu_torch.utils import viz2d

        world = make_world(n_frames=10, n_landmarks=200)
        pub = ViewerDataPublisher()
        tracker = TrackSimulator(world)
        slam = Slam.build(_params(), orb_extractor=FakeOrbExtractor(world, tracker),
                          device="cpu")
        slam.connect_debug_api(viewer_publisher=pub)
        _ = [f.result(timeout=60) for f in _run_session(slam, world, 10, tracker)]
        db = slam._mapper.map_db
        # fabricate one atlas map from the session's own keyframes (the
        # publisher export format) and record a relocation stage against it
        pub.set_atlas([db])
        atlas = pub.get_atlas()
        assert atlas and atlas[0]["keyframes"]
        atlas_kf = KfId(atlas[0]["keyframes"][0]["id"])
        db.loop_stages[MapKf(MapId(0), atlas_kf)] = \
            LoopStage.RELOCATION_MAP_POINT_RANSAC

        base = viz2d.render_map_orthographic(db)
        with_atlas = viz2d.render_map_orthographic(db, atlas=atlas)
        assert with_atlas.shape == base.shape
        assert not np.array_equal(base, with_atlas)
        # the atlas track renders in the reference's fg color
        fg = np.all(with_atlas == np.array(viz2d.COLOR_ATLAS, np.uint8), axis=-1)
        assert fg.any()
        # the relocation highlight must land on the atlas track, not on the
        # same-id current-map keyframe: the base render has no stage color
        stage_c = np.array(viz2d.STAGE_COLORS[int(
            LoopStage.RELOCATION_MAP_POINT_RANSAC)], np.uint8)
        assert not np.all(base == stage_c, axis=-1).any()
        assert np.all(with_atlas == stage_c, axis=-1).any()
        # alignment controls move the atlas map
        moved = viz2d.render_map_orthographic(
            db, atlas=atlas, atlas_controls=[(0.5, 3.0, -2.0)])
        assert not np.array_equal(with_atlas, moved)
        viz2d.write_png(str(tmp_path / "atlas.png"), with_atlas)
        slam.end().result(timeout=60)

    def test_map_point_search_view(self, tmp_path):
        """searchByProjection debug snapshot (reference:
        visualizeMapPointSearch, opencv_viewer_data_publisher.cpp:210-246):
        enabling the flag must capture candidate projections + matches and
        the renderer must produce an image."""
        from slam_tpu_torch.utils import viz2d

        world = make_world(n_frames=10, n_landmarks=200)
        pub = ViewerDataPublisher(ViewerParameters(visualizeMapPointSearch=True))
        tracker = TrackSimulator(world)
        slam = Slam.build(_params(), orb_extractor=FakeOrbExtractor(world, tracker),
                          device="cpu")
        slam.connect_debug_api(viewer_publisher=pub)
        _ = [f.result(timeout=60) for f in _run_session(slam, world, 10, tracker)]
        snap = pub.get_map_point_search()
        assert snap is not None
        assert len(snap["projectedMps"]) > 0
        img = viz2d.render_map_point_search(
            snap["frame"], [(m, k) for m, k in snap["matched"]],
            snap["projectedMps"], snap["unmatchedKps"])
        assert img.ndim == 3 and img.shape[2] == 3
        viz2d.write_png(str(tmp_path / "mp_search.png"), img)
        slam.end().result(timeout=60)


class TestCommandQueue:
    def test_wait_recording_and_step_gating(self):
        waits = []
        q = CommandQueue(wait_fn=lambda m: waits.append(m))
        assert q.get_step_mode() == StepMode.NONE
        pub = ViewerDataPublisher()

        class _DB:
            keyframes = {}
        # NONE mode: no publish, no wait
        step_wait(q, pub, _DB(), None, None, "nope")
        assert q.waits == [] and waits == []
        # SLAM mode: records + calls the wait fn (publish tolerates empty map)
        q.set_step_mode(StepMode.SLAM)
        step_wait(q, pub, _DB(), None, None, "Starting loop closure.")
        assert q.waits == ["Starting loop closure."]
        assert waits == ["Starting loop closure."]
        # missing publisher: still gated off
        step_wait(q, None, _DB(), None, None, "no publisher")
        assert len(q.waits) == 1

    def test_loop_closer_wait_sites(self):
        """The loop closer's step hooks fire through the same guarded idiom
        (reference wait sites loop_closer.cpp:382,436,478,552)."""
        from slam_tpu_torch.map.mapdb import MapDB
        from slam_tpu_torch.params import StaticSettings
        from slam_tpu_torch.pipeline.loop_closer import LoopCloser

        lc = LoopCloser(StaticSettings(Parameters()), bow_index=None,
                        map_db=MapDB(), device="cpu")
        msgs = []
        lc.commands = CommandQueue(StepMode.SLAM,
                                   wait_fn=lambda m: msgs.append(m))
        lc.data_publisher = ViewerDataPublisher()
        lc._step_wait("After rigid transform.")
        assert msgs == ["After rigid transform."]
        # without a publisher the wait must be skipped (reference guard)
        lc.data_publisher = None
        lc._step_wait("skipped")
        assert msgs == ["After rigid transform."]
