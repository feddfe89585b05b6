#!/usr/bin/env python
"""KITTI-class rendered street circuit through the PyTorch port.

The port's twin of ``tools/run_kitti_synthetic.py`` (BASELINE config 5:
500+ keyframes, global BA, relocation after tracking loss): a street canyon
(an outer wall ring, an inner city block, a ground plane) rendered at the
KITTI odometry cam0 geometry (1241x376, f=718.856, 10 Hz) and driven round
a circular circuit at 9 m/s, past one full lap, through ``slam_tpu_torch``:
raw frames -> ``DescriptorTracker`` -> ``Mapper`` with drift-injected
odometry (a translation random walk plus a heading-rate bias). Every frame
becomes a keyframe and culling is off (scale mode). A short blackout
mid-run kills every track. After the drive the map is saved, and a second
session loads it as an atlas map and re-drives an arc: the furthest
``LoopStage`` each atlas candidate reaches is recorded.

``make_street_scene`` and ``make_sequence`` are the port's copies of the
original's; the ray caster is ``tools/torch_run_euroc_synthetic.render``.

Usage:
  python tools/torch_run_kitti_synthetic.py [--frames N] [--drift SIGMA]
      [--drift-yaw RAD] [--radius M] [--stage-stats] [--no-reloc]
      [--no-blackout] [--no-scale] [--viz DIR] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_run_euroc_synthetic import (OUT_DIR, ate_rmse,  # shared ray-caster
                                       circle_pose_cw, render)

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.geometry.camera import PinholeCamera

# KITTI odometry grayscale cam0 (sequences 00-02 intrinsics), 10 Hz
CAM = PinholeCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                    width=1241, height=376)
FPS = 10.0

# street-canyon geometry (meters): outer wall ring half-extent, inner city
# block half-extent, wall height, circuit radius in the street between them.
# The circle must clear the inner block at the 45-degree diagonals:
# RADIUS / sqrt(2) = 56.6 > INNER (else the camera drives through walls).
OUTER = 95.0
INNER = 52.0
WALL_H = 10.0
RADIUS = 80.0
TEX_SIZE = 2048
SPEED = 9.0                     # m/s along the circuit (KITTI-urban-like)


def make_street_scene(seed=0, outer=OUTER, inner=INNER):
    """Planes in the ``render`` format: (axis, plane value, u-axis, v-axis,
    u half-extent, v half-extent). Block texture scale is chosen per plane
    so blocks are ~0.7 m: dense corners at every block boundary at 10-25 m
    viewing distance."""
    rng = np.random.default_rng(seed)

    def tex(extent_m):
        n_blocks = int(np.clip(2 * extent_m / 0.7, 16, 512))
        blocks = rng.integers(25, 231, (n_blocks, n_blocks)).astype(np.float32)
        reps = int(np.ceil(TEX_SIZE / n_blocks))
        coarse = np.kron(blocks, np.ones((reps, reps), np.float32))
        coarse = coarse[:TEX_SIZE, :TEX_SIZE]
        fine = rng.normal(0.0, 10.0, (TEX_SIZE, TEX_SIZE)).astype(np.float32)
        return np.clip(coarse + fine, 0, 255)

    hy = WALL_H / 2.0
    planes, textures = [], []
    # outer wall ring (faces inward)
    for ax in (0, 2):
        for sgn in (-1.0, 1.0):
            planes.append((ax, sgn * outer, 2 - ax, 1, outer, hy))
            textures.append(tex(outer))
    # inner city block (faces outward into the street)
    for ax in (0, 2):
        for sgn in (-1.0, 1.0):
            planes.append((ax, sgn * inner, 2 - ax, 1, inner, hy))
            textures.append(tex(inner))
    # ground plane (y is down in CV convention: ground at +hy)
    planes.append((1, hy, 0, 2, outer, outer))
    textures.append(tex(outer))
    return textures, planes


def make_sequence(n_frames, radius=RADIUS):
    """Circuit ground truth: constant-speed drive around the circle; the
    revisit happens after one full lap, ~frame 558 at the defaults."""
    times = np.arange(n_frames) / FPS
    step = SPEED / FPS / radius
    phases = np.arange(n_frames) * step
    poses_cw = np.stack([circle_pose_cw(p, radius=radius) for p in phases])
    return times, poses_cw


def drifted_pose_cw(pose_cw, drift_rw, drift_yaw, i):
    """The odometry pose of frame ``i``: the random-walk translation
    ``drift_rw`` composed onto the ground truth, and the world rotated
    about the y (up) axis by the heading bias ``drift_yaw * i``."""
    ang = drift_yaw * i
    c, s = np.cos(ang), np.sin(ang)
    yaw_inv = np.eye(4)
    yaw_inv[0, 0] = yaw_inv[2, 2] = c
    yaw_inv[0, 2] = -s                  # inverse of Rot_y(ang)
    yaw_inv[2, 0] = s
    return se3.se3_exp(np.concatenate([np.zeros(3), drift_rw])) \
        @ pose_cw @ yaw_inv


def drive(n_frames=620, drift=0.01, drift_yaw=4e-5, seed=0,
          blackout=(310, 314), reloc=True, progress=True, scale=True,
          radius=RADIUS, stage_stats=False, map_path="", device="cuda"):
    """The drive and, with ``reloc``, the relocation pass. Returns (result
    dict, mapper of the drive, [(mapper, tracker)] of every session)."""
    from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker
    from slam_tpu_torch.map.keyframe import MapperInput, Pose
    from slam_tpu_torch.params import (Parameters, ParametersSlam,
                                       StaticSettings)
    from slam_tpu_torch.pipeline.mapper import Mapper
    from slam_tpu_torch.utils import timer

    if stage_stats:
        timer.enable_timing()

    f = radius / RADIUS
    scene = make_street_scene(seed, outer=OUTER * f, inner=INNER * f)
    times, poses_cw = make_sequence(n_frames, radius=radius)
    rng = np.random.default_rng(seed + 7)

    map_path = map_path or os.path.join(OUT_DIR, "kitti_synth_map.npz")
    os.makedirs(os.path.dirname(os.path.abspath(map_path)), exist_ok=True)
    # scale mode (the config-5 point): every frame becomes a keyframe and
    # culling is off so the surviving map reaches KITTI-00 scale.
    # minInterval 0.05: at exactly 10 Hz float roundoff makes ~half the
    # frame gaps 0.0999.. < 0.1, which would drop them before the distance
    # gate ever ran
    kf_kwargs = dict(keyframeDecisionCovisibilityRatio=1.0,
                     keyframeCullMaxCriticalRatio=0.0,
                     keyframeDecisionMinIntervalSeconds=0.05) if scale else {}
    params = Parameters(slam=ParametersSlam(
        mapdbSavePath=map_path,
        keyframeDecisionDistanceThreshold=0.5,
        **kf_kwargs,
    ))
    tracker = DescriptorTracker(StaticSettings(params), CAM.width, CAM.height,
                                device=device)
    mapper = Mapper(params, device=device)

    drift_rw = np.zeros(3)
    odo_cw = []
    trail = []
    t_render = t_track = t_map = 0.0
    mapper_ms_trace = []
    track_resets = 0
    prev_ids = set()
    for i in range(n_frames):
        t0 = time.perf_counter()
        if blackout and blackout[0] <= i < blackout[1]:
            image = np.full((CAM.height, CAM.width), 18, np.uint8)
        else:
            image = render(scene, poses_cw[i], cam=CAM)
        t1 = time.perf_counter()
        tf = tracker.process(image)
        t2 = time.perf_counter()
        ids = set(int(v) for v in tf.tracked_id_list)
        if prev_ids and not (ids & prev_ids):
            track_resets += 1
        prev_ids = ids
        # odometry error model: translation random walk (sigma `drift` per
        # frame) plus a constant heading-rate bias (`drift_yaw` rad/frame).
        # The default 4e-5 rad/frame keeps the revisit correction (~1.8 m)
        # inside the loop closer's drift gates
        # (maximumDriftMetersPerSecond = 0.05 over the ~56 s lap allows
        # ~2.8 m)
        drift_rw += rng.normal(0.0, drift, 3)
        pose_cw = drifted_pose_cw(poses_cw[i], drift_rw, drift_yaw, i)
        odo_cw.append((times[i], pose_cw.copy()))
        trail.insert(0, Pose(frame_number=i, t=times[i], pose_cw=pose_cw))
        trail = trail[:8]
        mi = MapperInput(frame=image, camera=CAM,
                         track_ids=tf.tracked_id_list,
                         track_pts=tf.tracked_pts, track_depths=None,
                         pose_trail=list(trail), t=times[i])
        mapper.advance(mi)
        t3 = time.perf_counter()
        t_render += t1 - t0
        t_track += t2 - t1
        t_map += t3 - t2
        mapper_ms_trace.append(1e3 * (t3 - t2))
        if progress and i % 50 == 0:
            print(f"frame {i}: kfs={len(mapper.map_db.keyframes)} "
                  f"mps={len(mapper.map_db.map_points)} "
                  f"lc={len(mapper.map_db.loop_closure_edges)} "
                  f"mapper={np.mean(mapper_ms_trace[-50:]):.0f}ms", flush=True)
        if stage_stats and i > 0 and i % 100 == 0:
            # interval tables show which stages grow with the map
            print(f"--- stage table, frames {i - 100}..{i} "
                  f"(mps={len(mapper.map_db.map_points)})", flush=True)
            print(timer.TIME_STATS.table(), flush=True)
            timer.TIME_STATS.reset()

    traj_path = os.path.join(os.path.dirname(os.path.abspath(map_path)),
                             "kitti_synth_traj.csv")
    mapper.end(traj_path)

    gt_by_t = {float(t): se3.camera_center(p) for t, p in zip(times, poses_cw)}
    est = np.genfromtxt(traj_path, delimiter=",")

    def ate(rows):
        return ate_rmse(rows, gt_by_t)

    odo_rows = np.array([[t, *se3.camera_center(p)] for t, p in odo_cw])
    n = len(mapper_ms_trace)
    q = max(1, n // 4)
    centers = np.array([se3.camera_center(p) for p in poses_cw])
    result = {
        "frames": n_frames,
        "trajectory_m": round(float(np.sum(np.linalg.norm(
            np.diff(centers, axis=0), axis=1))), 1),
        "keyframes": len(mapper.map_db.keyframes),
        "map_points": len(mapper.map_db.map_points),
        "loop_closures": len(mapper.map_db.loop_closure_edges),
        "track_resets": track_resets,
        "ate_slam_m": ate(est) if est.ndim == 2 and len(est) else float("nan"),
        "ate_odometry_m": ate(odo_rows),
        "render_ms": round(1e3 * t_render / n, 1),
        "track_ms": round(1e3 * t_track / n, 1),
        "mapper_ms": round(1e3 * t_map / n, 1),
        # per-frame host time must stay bounded as the map grows
        "mapper_ms_first_quarter": round(float(np.mean(
            mapper_ms_trace[:q])), 1),
        "mapper_ms_last_quarter": round(float(np.mean(
            mapper_ms_trace[-q:])), 1),
        # candidate-rejection taxonomy (reference: loop_closer_stats.hpp)
        "loop_stats": {k.value: v for k, v in
                       mapper.loop_closer.stats.totals.items()},
    }
    if stage_stats:
        print(timer.TIME_STATS.table(), flush=True)
        timer.disable_timing()

    sessions = [(mapper, tracker)]
    if reloc:
        result["relocation"], reloc_mapper, reloc_tracker = \
            relocation_session(scene, map_path, radius=radius, device=device)
        sessions.append((reloc_mapper, reloc_tracker))
    return result, mapper, sessions


def run(n_frames=620, drift=0.01, drift_yaw=4e-5, seed=0, viz="",
        blackout=(310, 314), reloc=True, progress=True, scale=True,
        radius=RADIUS, stage_stats=False, map_path="", device="cuda"):
    """Returns a dict with the keys of ``tools/run_kitti_synthetic.run``."""
    result, mapper, _ = drive(n_frames, drift, drift_yaw, seed, blackout,
                              reloc, progress, scale, radius, stage_stats,
                              map_path, device)
    if viz:
        from slam_tpu_torch.utils.viz2d import PngDebugPublisher
        result["map_png"] = PngDebugPublisher(viz).visualize_map(
            mapper.map_db)
    return result


def relocation_session(scene, map_path, n_frames=50, radius=RADIUS,
                       device="cuda"):
    """Second session with the saved map loaded as a read-only atlas map:
    drive an arc of the same circuit and report how far relocation gets.
    Returns (result dict, mapper, tracker). The original drives the arc at
    the default radius whatever the drive's was, which puts it outside the
    walls of a smaller circuit; here it follows the drive's circuit."""
    from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker
    from slam_tpu_torch.map.keyframe import MapperInput, Pose
    from slam_tpu_torch.map.mapdb import CURRENT_MAP_ID
    from slam_tpu_torch.params import (Parameters, ParametersSlam,
                                       StaticSettings)
    from slam_tpu_torch.pipeline.mapper import Mapper

    params = Parameters(slam=ParametersSlam(
        mapdbLoadPath=[map_path],
        keyframeDecisionDistanceThreshold=0.5,
        keyframeDecisionCovisibilityRatio=0.97,
    ))
    tracker = DescriptorTracker(StaticSettings(params), CAM.width, CAM.height,
                                device=device)
    mapper = Mapper(params, device=device)
    step = SPEED / FPS / radius
    trail = []
    # loop_stages is cleared per keyframe, so accumulate the furthest stage
    # each atlas candidate reached over the whole arc
    best_stage = {}
    for i in range(n_frames):
        pose_cw = circle_pose_cw(i * step, radius=radius)
        image = render(scene, pose_cw, cam=CAM)
        tf = tracker.process(image)
        t = i / FPS
        trail.insert(0, Pose(frame_number=i, t=t, pose_cw=pose_cw))
        trail = trail[:8]
        mapper.advance(MapperInput(
            frame=image, camera=CAM, track_ids=tf.tracked_id_list,
            track_pts=tf.tracked_pts, track_depths=None,
            pose_trail=list(trail), t=t))
        for k, s in mapper.map_db.loop_stages.items():
            if k.map_id != CURRENT_MAP_ID and (
                    k not in best_stage or s.value > best_stage[k].value):
                best_stage[k] = s
    mapper.end("")
    by_stage = {}
    for s in best_stage.values():
        by_stage[s.name] = by_stage.get(s.name, 0) + 1
    return ({"atlas_keyframes": len(mapper.atlas[0].keyframes),
             "candidates_considered": len(best_stage),
             "stages": by_stage}, mapper, tracker)


def run_relocation_pass(scene, map_path, seed, n_frames=50, radius=RADIUS,
                        device="cuda"):
    """The relocation pass of ``tools/run_kitti_synthetic.py`` (``seed`` is
    unused there too); returns its result dict."""
    return relocation_session(scene, map_path, n_frames, radius, device)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=620)
    ap.add_argument("--drift", type=float, default=0.01)
    ap.add_argument("--drift-yaw", type=float, default=4e-5,
                    help="heading-rate bias, rad/frame")
    ap.add_argument("--radius", type=float, default=RADIUS,
                    help="circuit radius (scene scales with it); smaller "
                         "radius = shorter lap for quick loop diagnostics")
    ap.add_argument("--no-scale", action="store_true",
                    help="keep default keyframe decision + culling gates")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--viz", default="")
    ap.add_argument("--no-reloc", action="store_true")
    ap.add_argument("--stage-stats", action="store_true",
                    help="print the per-stage host time table at the end")
    ap.add_argument("--no-blackout", action="store_true")
    ap.add_argument("--map", default="",
                    help="where the drive saves its map (default under "
                         "build/torch_tools/)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(n_frames=args.frames, drift=args.drift,
              drift_yaw=args.drift_yaw, seed=args.seed,
              viz=args.viz, reloc=not args.no_reloc, scale=not args.no_scale,
              radius=args.radius, stage_stats=args.stage_stats,
              blackout=None if args.no_blackout else (args.frames // 2,
                                                      args.frames // 2 + 4),
              map_path=args.map, device=args.device)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
