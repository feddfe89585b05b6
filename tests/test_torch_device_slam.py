"""The port's ``DeviceSlam`` against the JAX package's, session for session,
on the loop-closure world of ``tests/test_device_vo.py``
(``TestDeviceLoopClosure``: 320x240, 64 frames, lap 32, a vertical
odometry bias of 5e-3 m per frame, chunks of 8), and the slow end-to-end
closure tests of that file ported onto the port alone.

The two packages' in-scan retrieval scores agree to the last bit except on
exact revisits, where the score is 1 in exact arithmetic and each package
rounds its 256-term dot product its own way (1.0, 0.99999994 or
1.0000001). The consumer tries the best-scoring flagged query of a chunk,
so one ulp decides between equally good revisits. The session test holds
the port's scores to the JAX package's (flags equal; 2 ulp on revisits,
5e-3 elsewhere, where a word can flip with the +-1 gray pyramid ties) and
then feeds the port's consumer the JAX scores, so that both consumers see
the same candidates.

The slow tests run the port, and two of them the port alone, where exact
revisits tie at 1.0 far more often; ties go to the first flagged query of
a chunk. On the JAX tests' world the chunks of 8 start on the square's
corners (sides of 8 frames), and a query on a corner matches no candidate
features, so the port-alone copies start the session 4 frames into the
first side: each chunk then opens mid-side. The JAX originals close on
their world only because their rounding scores frame 48 at 0.99999994 and
frame 50 at 1.0. The frozen-map merge test keeps its world and is fed the
JAX program's scores: its last assertion (lap 3 mints fewer landmarks than
lap 2) held, in CPU runs of both packages, only on that world; with the
session started 1-7 frames later the first closure comes earlier in lap 2,
and lap 3 then mints 127-429 landmarks against 24-181 left from lap 2, in
the JAX package (offsets 2, 4, 6) as in the port (1-7)."""
import numpy as np
import pytest
import torch

from synthetic_world import default_camera, make_world
from test_device_vo import _render_frames

from slam_tpu.pipeline import device_slam as jds
from slam_tpu.pipeline import device_vo as jvo
from slam_tpu_torch.geometry import camera as tcamera
from slam_tpu_torch.geometry import se3
from slam_tpu_torch.ops.hamming import hamming_matrix_host
from slam_tpu_torch.pipeline import device_vo as tvo
from slam_tpu_torch.pipeline.device_slam import DeviceSlam, DeviceSlamParams

torch.set_num_threads(1)
W, H, LAP, CHUNK = 320, 240, 32, 8
CFG = dict(width=W, height=H, lm_capacity=256, max_keypoints=200,
           ba_iterations=2, loop_every=2, loop_slots=32, loop_words=256,
           loop_min_gap=16, loop_points=128)


def _world(laps=2, drift_per_frame=5e-3, start=0):
    """Ground-truth poses, rendered frames and odometry of the square loop
    with a constant vertical odometry bias (the world of the JAX package's
    closure tests), for a session that starts at frame ``start`` of it."""
    T = LAP * laps
    world = make_world(n_frames=T + start, n_landmarks=700, seed=6,
                       trajectory="loop", lap_frames=LAP,
                       camera=default_camera(W, H))
    frames = _render_frames(world, T + start, seed=2)[start:]
    poses = np.stack(world.poses_cw[start:])
    bias = np.eye(4, dtype=np.float32)
    bias[1, 3] = drift_per_frame
    deltas = np.stack(
        [np.eye(4, dtype=np.float32)]
        + [bias @ (poses[i] @ np.linalg.inv(poses[i - 1])).astype(np.float32)
           for i in range(1, T)])
    return poses, frames, deltas


def _center(T):
    return -np.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])


def _port_session(poses, frames, deltas, cfg, params, on_chunk=None):
    slam = DeviceSlam(cfg, batch=1, camera=tcamera.default_camera(W, H),
                      params=params, device="cpu")
    slam.vo.reset(poses[:1].astype(np.float32))
    if on_chunk is not None:
        advance = slam.vo.advance
        slam.vo.advance = lambda i, d: on_chunk(advance(i, d))
    for c in range(frames.shape[0] // CHUNK):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        slam.advance(frames[None, sl], deltas[None, sl])
    slam.finish()
    return slam


def _fed_jax_scores(flags):
    """An ``on_chunk`` hook for :func:`_port_session`: holds each chunk's
    port flags and scores to the JAX program's next ``(loop_frame,
    loop_score)`` and hands the consumer the JAX scores."""
    def feed(out):
        lf, ls = flags.pop(0)
        np.testing.assert_array_equal(out.loop_frame.numpy(), lf)
        got = out.loop_score.numpy()
        revisit = ls >= 0.99
        assert np.abs(got - ls)[revisit].max(initial=0) <= 2.4e-7
        assert np.abs(got - ls).max() <= 5e-3
        return out._replace(loop_score=torch.from_numpy(ls.copy()))
    return feed


def _jax_flags(poses, frames, deltas, cfg):
    """Per-chunk (loop_frame, loop_score) of the JAX package's VO on these
    frames. Retrieval reads only the front-end's words and the ring's
    frames, so closures and rebases do not change them."""
    vo = jvo.BatchedDeviceVO(jvo.DeviceVOConfig(**cfg), batch=1,
                             camera=default_camera(W, H))
    vo.reset(poses[:1].astype(np.float32))
    flags = []
    for c in range(frames.shape[0] // CHUNK):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        out = vo.advance(frames[None, sl], deltas[None, sl])
        flags.append((np.asarray(out.loop_frame), np.asarray(out.loop_score)))
    return flags


def test_session_matches_jax():
    poses, frames, deltas = _world()
    params = dict(frame_dt=0.1, calib_frames=24)
    p0 = poses[:1].astype(np.float32)

    jslam = jds.DeviceSlam(jvo.DeviceVOConfig(**CFG), batch=1,
                           camera=default_camera(W, H),
                           params=jds.DeviceSlamParams(**params))
    jslam.vo.state = jslam.vo.state._replace(pose_cw=p0, prev_pose_cw=p0)
    flags = []
    jadvance = jslam.vo.advance

    def record(i, d):
        out = jadvance(i, d)
        flags.append((np.asarray(out.loop_frame), np.asarray(out.loop_score)))
        return out
    jslam.vo.advance = record
    for c in range(frames.shape[0] // CHUNK):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        jslam.advance(frames[None, sl], deltas[None, sl])
    jslam.finish()

    tslam = _port_session(poses, frames, deltas, tvo.DeviceVOConfig(**CFG),
                          DeviceSlamParams(**params),
                          on_chunk=_fed_jax_scores(flags))
    assert not flags

    def events(s):
        return [(e.query_frame, e.cand_frame, e.accepted, e.reason)
                for e in s.closures]
    assert events(tslam) == events(jslam)
    assert (50, 18, True, "ok") in events(tslam)
    # match and inlier counts equal too: the snapshots agree to f32
    # rounding, far inside the chi2 gates
    assert ([(e.n_matches, e.n_inliers) for e in tslam.closures]
            == [(e.n_matches, e.n_inliers) for e in jslam.closures])
    assert tslam.closure_lags == jslam.closure_lags == [14]
    assert tslam._score_gate == jslam._score_gate
    acc_t = [e for e in tslam.closures if e.accepted][0]
    acc_j = [e for e in jslam.closures if e.accepted][0]
    np.testing.assert_allclose(acc_t.T, acc_j.T, atol=1e-4)
    # the corrected trajectory and the rebased device state, within 1e-3 m
    traj_t, traj_j = tslam.trajectory(0), jslam.trajectory(0)
    assert traj_t.shape == traj_j.shape == (64, 4, 4)
    assert np.linalg.norm(_center(traj_t) - _center(traj_j),
                          axis=-1).max() < 1e-3
    pose_t = tslam.vo.state.pose_cw.numpy()[0]
    pose_j = np.asarray(jslam.vo.state.pose_cw)[0]
    assert np.linalg.norm(_center(pose_t) - _center(pose_j)) < 1e-3


@pytest.mark.slow
class TestDeviceLoopClosure:
    """The JAX package's ``TestDeviceLoopClosure`` on the port alone: the
    host consumer verifies the in-scan retrieval flags with the drift gates
    at their DEFAULT values, corrects the trajectory and rebases the
    device-resident state."""

    def test_closure_corrects_drifted_trajectory(self):
        poses, frames, deltas = _world(start=4)
        cfg = tvo.DeviceVOConfig(**CFG)
        params = DeviceSlamParams(frame_dt=0.1, calib_frames=24)
        control = _port_session(poses, frames, deltas, cfg,
                                params._replace(apply_closures=False))
        slam = _port_session(poses, frames, deltas, cfg, params)

        accepted = [e for e in slam.closures if e.accepted]
        assert accepted, [e.reason for e in slam.closures]
        ev = accepted[0]
        assert abs((ev.query_frame - ev.cand_frame) - LAP) <= cfg.loop_every
        assert ev.n_inliers >= 20
        gate = slam._score_gate[0]
        assert gate is not None and 0.80 < gate < 0.99, gate
        assert all(e.query_frame >= LAP for e in accepted)
        dflt = DeviceSlamParams()
        assert slam.params.max_drift_m_per_s == dflt.max_drift_m_per_s
        assert slam.params.max_drift_rad_per_s == dflt.max_drift_rad_per_s

        def tail_err(s):
            traj = s.trajectory(0)
            q = ev.query_frame
            return float(np.mean([
                np.linalg.norm(se3.camera_center(traj[i])
                               - se3.camera_center(poses[i]))
                for i in range(q, len(traj))]))

        e_ctrl, e_closed = tail_err(control), tail_err(slam)
        assert e_closed < 0.7 * e_ctrl, (e_closed, e_ctrl)
        # the device state was rebased: it equals the control's state
        # right-multiplied by the accepted correction
        pose_state = slam.vo.state.pose_cw.numpy()[0]
        pose_ctrl = control.vo.state.pose_cw.numpy()[0]
        np.testing.assert_allclose(pose_state, pose_ctrl @ ev.T,
                                   rtol=1e-4, atol=1e-4)
        assert np.abs(pose_state - slam.trajectory(0)[-1]).max() < 0.05

        # control run: flags were verified but nothing moved
        assert any(e.accepted for e in control.closures)
        vo_plain = tvo.BatchedDeviceVO(cfg, batch=1,
                                       camera=tcamera.default_camera(W, H),
                                       device="cpu")
        vo_plain.reset(poses[:1].astype(np.float32))
        out_plain = vo_plain.advance(frames[None], deltas[None])
        np.testing.assert_allclose(control.trajectory(0),
                                   out_plain.pose_cw.numpy()[0],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.slow
class TestDeviceMultiClosure:
    """The JAX package's ``TestDeviceMultiClosure`` on the port alone: two
    accepted closures over 3 laps with the in-scan window BA, and the
    post-closure duplicate-landmark merge on a frozen map."""

    def test_two_closures_with_window_ba(self):
        poses, frames, deltas = _world(laps=3, start=4)
        cfg = tvo.DeviceVOConfig(**{**CFG, "window": 8,
                                    "window_ba_every": 4})
        params = DeviceSlamParams(frame_dt=0.1, calib_frames=24,
                                  min_closure_gap_s=2.0)
        slam = _port_session(poses, frames, deltas, cfg, params)
        control = _port_session(poses, frames, deltas, cfg,
                                params._replace(apply_closures=False))

        accepted = [e for e in slam.closures if e.accepted]
        assert len(accepted) >= 2, [(e.reason, e.query_frame)
                                    for e in slam.closures]
        qs = [e.query_frame for e in accepted]
        assert qs[1] - qs[0] >= 20
        assert slam.closure_lags and all(0 < l <= 24
                                         for l in slam.closure_lags)

        def tail_err(s, f0):
            traj = s.trajectory(0)
            return float(np.mean([
                np.linalg.norm(se3.camera_center(traj[i])
                               - se3.camera_center(poses[i]))
                for i in range(f0, len(traj))]))

        e_ctrl = tail_err(control, 2 * LAP)
        e_closed = tail_err(slam, 2 * LAP)
        assert e_closed < 0.7 * e_ctrl, (e_closed, e_ctrl)
        pose_state = slam.vo.state.pose_cw.numpy()[0]
        assert np.abs(pose_state - slam.trajectory(0)[-1]).max() < 0.05
        pose_ctrl = control.vo.state.pose_cw.numpy()[0]
        assert np.linalg.norm(se3.camera_center(pose_state)
                              - se3.camera_center(pose_ctrl)) > 0.08
        assert torch.isfinite(slam.vo.state.win_pose_cw).all()

    def test_merge_collapses_frozen_map_duplicates(self):
        """Frozen map (stale_age >= episode), a 0.5 m odometry fault at the
        lap boundary: lap 2 mints displaced duplicates, the closure recovers
        the shift and the merge collapses them; re-traversal does not
        re-mint them. Drift gates loosened as in the JAX package's test;
        the consumer sees the JAX program's retrieval scores (module
        docstring)."""
        poses, frames, deltas = _world(laps=3, drift_per_frame=0.0)
        fault = np.eye(4, dtype=np.float32)
        fault[1, 3] = 0.5
        deltas[LAP] = fault @ deltas[LAP]
        cfg = tvo.DeviceVOConfig(**{**CFG, "lm_capacity": 2048, "window": 0,
                                    "stale_age": 10 ** 6,
                                    "max_depth_step": 0.0})
        params = DeviceSlamParams(frame_dt=0.1, calib_frames=24,
                                  min_closure_gap_s=2.0,
                                  max_drift_m_per_s=10.0,
                                  max_drift_m_per_m=10.0,
                                  max_drift_rad_per_s=1.0,
                                  max_drift_rad_per_m=1.0,
                                  merge_radius_m=0.3)

        def dup_count(slam):
            st = tvo.state_to_numpy(slam.vo.state)
            valid = st["lm_valid"][0]
            pos = st["lm_pos"][0][valid]
            desc = st["lm_desc"][0][valid]
            ham = hamming_matrix_host(desc, desc)
            d3 = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
            pair = (ham <= 50) & (d3 <= 0.3)
            return int(np.triu(pair, k=1).sum())

        flags = _jax_flags(poses, frames, deltas, cfg._asdict())
        slam = _port_session(poses, frames, deltas, cfg, params,
                             on_chunk=_fed_jax_scores(list(flags)))
        no_merge = _port_session(poses, frames, deltas, cfg,
                                 params._replace(merge_landmarks=False),
                                 on_chunk=_fed_jax_scores(list(flags)))

        assert any(e.accepted for e in slam.closures), \
            [e.reason for e in slam.closures]
        assert any(e.accepted for e in no_merge.closures)
        d_merge, d_plain = dup_count(slam), dup_count(no_merge)
        assert d_merge < 0.5 * d_plain, (d_merge, d_plain)

        q0 = min(e.query_frame for e in slam.closures if e.accepted)
        created = slam.vo.state.lm_created.numpy()[0]
        valid = slam.vo.state.lm_valid.numpy()[0]
        lap2 = int(((created >= LAP) & (created < 2 * LAP) & valid).sum())
        lap3 = int(((created >= 2 * LAP) & valid).sum())
        assert lap3 < 0.7 * max(lap2, 1) + 5, (lap2, lap3, q0)
