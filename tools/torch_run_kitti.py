#!/usr/bin/env python
"""Run the port's SLAM backend on a KITTI odometry sequence (image_0).

The port's twin of ``tools/run_kitti.py``, the same harness pattern as
``tools/torch_run_euroc.py``: odometry poses come from the dataset's poses
file (``--poses``, KITTI 3x4 row-major) with optional synthetic drift,
exercising large-scale mapping, global BA and relocation (BASELINE config
5). Frames are decoded with PIL.

Usage:
  python tools/torch_run_kitti.py <sequence_dir> --poses poses/00.txt
      [--frames N] [--stride K] [--drift SIGMA] [--out traj.csv]
      [--map map.npz] [--device cuda|cpu]
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

# KITTI odometry grayscale camera (sequence 00-02 intrinsics)
KITTI_CAM = PinholeCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                          width=1241, height=376)


def main(argv=None):
    """Runs the sequence; returns the mapper."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seq_dir")
    ap.add_argument("--poses", required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--drift", type=float, default=0.0)
    ap.add_argument("--out", default="trajectory_kitti.csv")
    ap.add_argument("--map", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    img_dir = os.path.join(args.seq_dir, "image_0")
    files = sorted(os.listdir(img_dir))
    if args.frames:
        files = files[:args.frames]
    poses = np.loadtxt(args.poses).reshape(-1, 3, 4)  # T_w_cam per frame

    params = Parameters(slam=ParametersSlam(
        mapdbSavePath=args.map,
        keyframeDecisionDistanceThreshold=2.0,
        adjacentSpaceSize=30,
        localBAProblemSize=30))
    settings = StaticSettings(params)
    mapper = Mapper(params, device=args.device)
    tracker = None
    rng = np.random.default_rng(0)
    drift_state = np.zeros(3)
    trail = []

    for frame_idx, name in enumerate(files):
        if frame_idx % args.stride:
            continue
        image = np.asarray(Image.open(os.path.join(img_dir, name))
                           .convert("L"))
        if tracker is None:
            h, w = image.shape
            tracker = DescriptorTracker(settings, w, h, device=args.device)
        tf = tracker.process(image)
        T_wc = np.eye(4)
        T_wc[:3] = poses[frame_idx]
        pose_cw = np.linalg.inv(T_wc)
        if args.drift > 0:
            drift_state += rng.normal(0, args.drift, 3)
            pose_cw = se3.se3_exp(np.concatenate([np.zeros(3),
                                                  drift_state])) @ pose_cw
        t = frame_idx * 0.1  # 10 Hz
        trail.insert(0, Pose(frame_number=frame_idx, t=t, pose_cw=pose_cw))
        trail = trail[:8]
        mi = MapperInput(frame=image, camera=KITTI_CAM,
                         track_ids=tf.tracked_id_list,
                         track_pts=tf.tracked_pts,
                         track_depths=None, pose_trail=list(trail), t=t)
        mapper.advance(mi)
        if frame_idx % 50 == 0:
            print(f"frame {frame_idx}: kfs={len(mapper.map_db.keyframes)} "
                  f"mps={len(mapper.map_db.map_points)}")

    mapper.end(args.out)
    print(f"wrote {args.out}; keyframes={len(mapper.map_db.keyframes)}")
    return mapper


if __name__ == "__main__":
    main()
