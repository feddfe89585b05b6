#!/usr/bin/env python
"""EuRoC-class rendered sequence through the PyTorch port.

The port's twin of ``tools/run_euroc_synthetic.py`` (BASELINE configs 3/4):
a ray-cast textured room at the EuRoC cam0 geometry (752x480, fx=458.654
fy=457.296 cx=367.215 cy=248.375, 20 Hz), flown once round a circle and
past its start, through the real-image pipeline of ``slam_tpu_torch``: raw
frames -> ``DescriptorTracker`` (ORB front-end and its words on the device)
-> ``Mapper`` with drift-injected ground-truth odometry (a translation random
walk, an 8-pose trail). It reports the ATE RMSE of the SLAM trajectory and of
the drifted odometry input; the backend's job is to beat its own input.

The scene code (``make_scene``, ``render``, ``circle_pose_cw``,
``make_sequence``, ``ate_rmse``) is the port's own copy of the original's,
held to it frame for frame by ``tests/test_torch_tools_scenes.py``; the
other ``tools/torch_*`` twins import it from here.

Usage:
  python tools/torch_run_euroc_synthetic.py [--frames N] [--stride K]
      [--drift SIGMA] [--seed S] [--out traj.csv] [--viz DIR]
      [--dump-frames DIR] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.geometry.camera import PinholeCamera

# EuRoC cam0 geometry; rendering is undistorted (k=0) so the renderer and
# the pipeline share one camera model
CAM = PinholeCamera(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                    width=752, height=480)

ROOM = (10.0, 3.0, 10.0)          # x, y (up), z extents, centered on origin
TEX_SIZE = 1024
# trajectory files and maps land here unless the caller names a path
OUT_DIR = os.path.join(ROOT, "build", "torch_tools")


def make_scene(seed=0, tile=0):
    """Six textured planes. Texture = coarse random blocks (strong corners at
    every block boundary) + fine noise (descriptor distinctiveness).

    ``tile > 0``: repeating textures, one small random motif tiled
    ``tile x tile`` across each plane, so visually identical patches recur
    across the wall (the adversarial world for Hamming association and
    appearance retrieval)."""
    rng = np.random.default_rng(seed)
    textures = []
    for _ in range(6):
        if tile > 0:
            motif_blocks = rng.integers(30, 226, (64 // tile, 64 // tile)
                                        ).astype(np.float32)
            blocks = np.tile(motif_blocks, (tile, tile))
        else:
            blocks = rng.integers(30, 226, (64, 64)).astype(np.float32)
        coarse = np.kron(blocks, np.ones((TEX_SIZE // 64, TEX_SIZE // 64),
                                         np.float32))
        fine = rng.normal(0.0, 12.0, (TEX_SIZE, TEX_SIZE)).astype(np.float32)
        if tile > 0:
            # tile the fine noise with the same period: otherwise the noise
            # alone disambiguates the repeats
            period = TEX_SIZE // tile
            fine = np.tile(fine[:period, :period], (tile, tile))
        textures.append(np.clip(coarse + fine, 0, 255))
    hx, hy, hz = ROOM[0] / 2, ROOM[1] / 2, ROOM[2] / 2
    # (axis, plane value, u-axis, v-axis, u extent, v extent)
    planes = [(0, -hx, 2, 1, hz, hy), (0, hx, 2, 1, hz, hy),
              (1, -hy, 0, 2, hx, hz), (1, hy, 0, 2, hx, hz),
              (2, -hz, 0, 1, hx, hy), (2, hz, 0, 1, hx, hy)]
    return textures, planes


_PIX_CACHE = {}


def _pixel_dirs(cam):
    key = (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy)
    if key not in _PIX_CACHE:
        u, v = np.meshgrid(np.arange(cam.width) + 0.5,
                           np.arange(cam.height) + 0.5)
        d = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                      np.ones_like(u)], axis=-1)
        _PIX_CACHE[key] = d.astype(np.float64)
    return _PIX_CACHE[key]


def render(scene, pose_cw, cam=CAM):
    """Ray-cast the scene through ``pose_cw`` (world->camera). Returns a
    uint8 (H, W) image with mild distance shading."""
    textures, planes = scene
    R = pose_cw[:3, :3]
    center = -R.T @ pose_cw[:3, 3]
    dirs = _pixel_dirs(cam) @ R                 # (H, W, 3) world-frame rays
    H, W = dirs.shape[:2]
    best_t = np.full((H, W), np.inf)
    img = np.zeros((H, W), np.float32)
    for tex, (ax, val, ua, va, ue, ve) in zip(textures, planes):
        da = dirs[..., ax]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (val - center[ax]) / da
        pu = center[ua] + t * dirs[..., ua]
        pv = center[va] + t * dirs[..., va]
        hit = (t > 1e-6) & (np.abs(pu) <= ue) & (np.abs(pv) <= ve) \
            & (t < best_t)
        if not hit.any():
            continue
        ts_v, ts_u = tex.shape           # size from the texture itself, so
        tu = (pu[hit] + ue) / (2 * ue) * (ts_u - 1)   # callers may pass any
        tv = (pv[hit] + ve) / (2 * ve) * (ts_v - 1)   # resolution
        iu, iv = tu.astype(np.int64), tv.astype(np.int64)
        fu, fv = tu - iu, tv - iv
        iu1 = np.minimum(iu + 1, ts_u - 1)
        iv1 = np.minimum(iv + 1, ts_v - 1)
        val_px = (tex[iv, iu] * (1 - fu) * (1 - fv)
                  + tex[iv, iu1] * fu * (1 - fv)
                  + tex[iv1, iu] * (1 - fu) * fv
                  + tex[iv1, iu1] * fu * fv)
        shade = 1.0 / (1.0 + 0.06 * t[hit])
        img[hit] = val_px * shade
        best_t[hit] = t[hit]
    return np.clip(img, 0, 255).astype(np.uint8)


def circle_pose_cw(phase, radius=3.2, y=0.0):
    """Camera on a circle in the xz-plane looking along the direction of
    travel (tangent); CV convention: z forward, y down."""
    c = np.array([radius * np.cos(phase), y, radius * np.sin(phase)])
    fwd = np.array([-np.sin(phase), 0.0, np.cos(phase)])
    down = np.array([0.0, -1.0, 0.0])
    right = np.cross(down, fwd)
    R_wc = np.stack([right, down, fwd], axis=1)     # camera axes in world
    pose = np.eye(4)
    pose[:3, :3] = R_wc.T
    pose[:3, 3] = -R_wc.T @ c
    return pose


def make_sequence(n_frames, seed=0, fps=20.0):
    """Ground-truth trajectory: one full loop plus overlap (revisit)."""
    times = np.arange(n_frames) / fps
    phases = np.linspace(0.0, 2.0 * np.pi * 1.12, n_frames)
    poses_cw = np.stack([circle_pose_cw(p) for p in phases])
    return times, poses_cw


def ate_rmse(rows, gt_by_t):
    """ATE RMSE of (t, x, y, z[, ...]) rows vs a {t: gt_center} dict,
    nearest-time association, translation-aligned (mean removed). Shared by
    the EuRoC- and KITTI-class runners."""
    err = np.array([r[1:4] - gt_by_t[min(gt_by_t, key=lambda t:
                                         abs(t - r[0]))] for r in rows])
    err -= err.mean(axis=0)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def drive(n_frames=240, stride=1, drift=0.0015, seed=0, out="",
          dump_frames="", progress=True, device="cuda"):
    """Render and run the pipeline. Returns (result dict, mapper, tracker);
    ``run`` keeps the dict."""
    from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker
    from slam_tpu_torch.map.keyframe import MapperInput, Pose
    from slam_tpu_torch.params import (Parameters, ParametersSlam,
                                       StaticSettings)
    from slam_tpu_torch.pipeline.mapper import Mapper

    scene = make_scene(seed)
    times, poses_cw = make_sequence(n_frames, seed)
    rng = np.random.default_rng(seed + 7)

    params = Parameters(slam=ParametersSlam())
    tracker = DescriptorTracker(StaticSettings(params), CAM.width,
                                CAM.height, device=device)
    mapper = Mapper(params, device=device)

    drift_rw = np.zeros(3)
    odo_cw = []
    trail = []
    t_render = t_track = t_map = 0.0
    for i in range(0, n_frames, stride):
        t0 = time.perf_counter()
        image = render(scene, poses_cw[i])
        t1 = time.perf_counter()
        if dump_frames:
            from slam_tpu_torch.utils.viz2d import write_png
            os.makedirs(dump_frames, exist_ok=True)
            write_png(os.path.join(dump_frames, f"{i:05d}.png"),
                      np.repeat(image[..., None], 3, axis=-1))
        tf = tracker.process(image)
        t2 = time.perf_counter()
        # drifted odometry input (the reference's host-VIO contract):
        # translation random walk composed onto ground truth
        drift_rw += rng.normal(0.0, drift, 3)
        pose_cw = se3.se3_exp(np.concatenate([np.zeros(3), drift_rw])) \
            @ poses_cw[i]
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
        if progress and (i // stride) % 25 == 0:
            print(f"frame {i}: kfs={len(mapper.map_db.keyframes)} "
                  f"mps={len(mapper.map_db.map_points)} "
                  f"lc={len(mapper.map_db.loop_closure_edges)}", flush=True)

    traj_path = out or os.path.join(OUT_DIR, "euroc_synth_traj.csv")
    os.makedirs(os.path.dirname(os.path.abspath(traj_path)), exist_ok=True)
    mapper.end(traj_path)

    # ATE RMSE (translation-aligned), SLAM vs raw odometry input
    gt_by_t = {float(t): se3.camera_center(p) for t, p in
               zip(times, poses_cw)}
    est = np.genfromtxt(traj_path, delimiter=",")
    est = est[np.isin(np.round(est[:, 0], 6),
                      np.round(list(gt_by_t.keys()), 6))]

    def ate(rows):
        return ate_rmse(rows, gt_by_t)

    odo_rows = np.array([[t, *se3.camera_center(p)] for t, p in odo_cw])
    n = max(1, n_frames // stride)
    result = {
        "frames": n_frames // stride,
        "keyframes": len(mapper.map_db.keyframes),
        "map_points": len(mapper.map_db.map_points),
        "loop_closures": len(mapper.map_db.loop_closure_edges),
        "ate_slam_m": ate(est) if est.ndim == 2 and len(est) else float("nan"),
        "ate_odometry_m": ate(odo_rows),
        "render_ms": 1e3 * t_render / n,
        "track_ms": 1e3 * t_track / n,
        "mapper_ms": 1e3 * t_map / n,
    }
    return result, mapper, tracker


def run(n_frames=240, stride=1, drift=0.0015, seed=0, out="", viz="",
        dump_frames="", progress=True, device="cuda"):
    """Render + run the full pipeline; returns a result dict with the keys
    of ``tools/run_euroc_synthetic.run``."""
    result, mapper, _ = drive(n_frames, stride, drift, seed, out,
                              dump_frames, progress, device)
    if viz:
        from slam_tpu_torch.utils.viz2d import PngDebugPublisher
        result["map_png"] = PngDebugPublisher(viz).visualize_map(
            mapper.map_db)
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--drift", type=float, default=0.0015)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--viz", default="")
    ap.add_argument("--dump-frames", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(n_frames=args.frames, stride=args.stride, drift=args.drift,
              seed=args.seed, out=args.out, viz=args.viz,
              dump_frames=args.dump_frames, device=args.device)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
