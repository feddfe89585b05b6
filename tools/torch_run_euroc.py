#!/usr/bin/env python
"""Run the port's SLAM backend on an EuRoC MAV (ASL-format) sequence.

The port's twin of ``tools/run_euroc.py``. The backend is driven by a host
VIO's odometry poses; this harness supplies them from an external odometry
CSV (any VIO system: t,x,y,z,qx,qy,qz,qw) or from the dataset's ground truth
with synthetic drift injected (``--drift``), which benchmarks the backend in
isolation (BASELINE configs 3/4). Tracks come from the port's
``DescriptorTracker``; frames are decoded with PIL.

Usage:
  python tools/torch_run_euroc.py <euroc_seq_dir> [--frames N] [--stride K]
      [--drift SIGMA] [--odometry odo.csv] [--out traj.csv] [--map map.npz]
      [--viz out_dir] [--device cuda|cpu]

ATE RMSE against the ground truth is printed at the end when it exists.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker
from slam_tpu_torch.geometry import se3
from slam_tpu_torch.geometry.camera import PinholeCamera
from slam_tpu_torch.map.keyframe import MapperInput, Pose
from slam_tpu_torch.params import Parameters, ParametersSlam, StaticSettings
from slam_tpu_torch.pipeline.mapper import Mapper

# EuRoC cam0 intrinsics (sensor.yaml of the MAV datasets)
EUROC_CAM0 = PinholeCamera(
    fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480,
    k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)


def load_images(seq_dir, max_frames=None):
    cam_dir = os.path.join(seq_dir, "mav0", "cam0", "data")
    if not os.path.isdir(cam_dir):
        cam_dir = os.path.join(seq_dir, "cam0", "data")
    files = sorted(os.listdir(cam_dir))
    if max_frames:
        files = files[:max_frames]
    for name in files:
        t_ns = int(os.path.splitext(name)[0])
        yield t_ns * 1e-9, os.path.join(cam_dir, name)


def load_groundtruth(seq_dir):
    for sub in ("mav0/state_groundtruth_estimate0/data.csv",
                "state_groundtruth_estimate0/data.csv"):
        path = os.path.join(seq_dir, sub)
        if os.path.exists(path):
            rows = np.genfromtxt(path, delimiter=",", skip_header=1)
            # t, p, q(wxyz)
            return rows[:, 0] * 1e-9, rows[:, 1:4], rows[:, 4:8]
    return None


def gt_pose_cw(t, gt, drift_state, drift_sigma, rng):
    """Interpolated ground-truth pose -> camera pose with injected drift."""
    ts, ps, qs = gt
    i = np.clip(np.searchsorted(ts, t), 1, len(ts) - 1)
    a = (t - ts[i - 1]) / max(ts[i] - ts[i - 1], 1e-9)
    p = (1 - a) * ps[i - 1] + a * ps[i]
    qw, qx, qy, qz = qs[i]
    R_wb = se3.quat_to_rmat(np.array([qx, qy, qz, qw]))
    T_wb = np.eye(4)
    T_wb[:3, :3] = R_wb
    T_wb[:3, 3] = p
    T_cw = np.linalg.inv(T_wb)  # body ~ camera up to extrinsic; fine for ATE
    if drift_sigma > 0:
        drift_state += rng.normal(0, drift_sigma, 3)
        T_cw = se3.se3_exp(np.concatenate([np.zeros(3), drift_state])) @ T_cw
    return T_cw, drift_state


def load_odometry_csv(path):
    rows = np.genfromtxt(path, delimiter=",")
    return rows[:, 0], rows[:, 1:4], rows[:, 4:8]  # t, p, q(xyzw)


def ate_rmse(est_rows: np.ndarray, gt) -> float:
    """Translation-aligned ATE RMSE of trajectory rows (t,x,y,z,...) against
    the (t, p, q) ground-truth tuple."""
    ts, ps, _ = gt
    idx = np.clip(np.searchsorted(ts, est_rows[:, 0]), 0, len(ts) - 1)
    err = est_rows[:, 1:4] - ps[idx]
    err = err - err.mean(axis=0)  # alignment: translation only
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def main(argv=None):
    """Runs the sequence; returns the mapper."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seq_dir")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--drift", type=float, default=0.0)
    ap.add_argument("--odometry", default=None)
    ap.add_argument("--out", default="trajectory.csv")
    ap.add_argument("--map", default="")
    ap.add_argument("--viz", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    gt = load_groundtruth(args.seq_dir)
    odo = load_odometry_csv(args.odometry) if args.odometry else None
    if gt is None and odo is None:
        sys.exit("need ground truth or --odometry csv for pose-trail input")

    params = Parameters(slam=ParametersSlam(mapdbSavePath=args.map))
    settings = StaticSettings(params)
    tracker = None
    mapper = Mapper(params, device=args.device)
    rng = np.random.default_rng(0)
    drift_state = np.zeros(3)
    trail = []
    n_processed = 0

    for frame_idx, (t, img_path) in enumerate(load_images(args.seq_dir,
                                                          args.frames)):
        if frame_idx % args.stride:
            continue
        image = np.asarray(Image.open(img_path).convert("L"))
        if tracker is None:
            h, w = image.shape
            tracker = DescriptorTracker(settings, w, h, device=args.device)
        tf = tracker.process(image)
        if odo is not None:
            ts, ps, qs = odo
            i = np.clip(np.searchsorted(ts, t), 1, len(ts) - 1)
            R = se3.quat_to_rmat(qs[i])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = ps[i]
            pose_cw = np.linalg.inv(T)
        else:
            pose_cw, drift_state = gt_pose_cw(t, gt, drift_state, args.drift,
                                              rng)
        trail.insert(0, Pose(frame_number=frame_idx, t=t, pose_cw=pose_cw))
        trail = trail[:8]
        mi = MapperInput(frame=image, camera=EUROC_CAM0,
                         track_ids=tf.tracked_id_list,
                         track_pts=tf.tracked_pts, track_depths=None,
                         pose_trail=list(trail), t=t)
        pose, cloud = mapper.advance(mi)
        n_processed += 1
        if n_processed % 25 == 0:
            print(f"frame {frame_idx}: kfs={len(mapper.map_db.keyframes)} "
                  f"mps={len(mapper.map_db.map_points)} pts={len(cloud)}")

    mapper.end(args.out)
    print(f"wrote {args.out}; map keyframes={len(mapper.map_db.keyframes)}")
    if args.viz:
        from slam_tpu_torch.utils.viz2d import PngDebugPublisher
        pub = PngDebugPublisher(args.viz)
        print("map view:", pub.visualize_map(mapper.map_db))

    if gt is not None:
        est = np.genfromtxt(args.out, delimiter=",")
        if est.ndim == 2 and len(est):
            ate = ate_rmse(est, gt)
            print(f"ATE RMSE (translation-aligned): {ate:.4f} m over "
                  f"{len(est)} keyframes")
    return mapper


if __name__ == "__main__":
    main()
