#!/usr/bin/env python
"""Steady-state per-stage host timings of the port's interactive pipeline.

The port's twin of ``tools/profile_pipeline.py``: ``bench.py``'s rendered
dot-field world (a line trajectory of 500 landmarks, each splatting an
11x11 patch, 640x480) through ``slam_tpu_torch``'s ``Mapper`` at the
pipeline bench's parameters, the next frame's extraction prefetched while
the current one maps. A throwaway full pass first absorbs first-use costs
(allocator growth, the vocabulary's upload, kernel builds); then a fresh
session runs ``--warm`` frames untimed and the rest under ``utils/timer``
sections, with the prefetch and advance walls split. Prints frames/s, the
two walls and the section table.

Usage:
  python tools/torch_profile_pipeline.py [--frames 36] [--warm 6]
      [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from slam_tpu_torch.map.keyframe import MapperInput, Pose
from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.mapper import Mapper
from slam_tpu_torch.utils import timer
from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                            render_frame)

# bench.py's pipeline-bench parameters
PARAMS = dict(keyframeDecisionMinIntervalSeconds=0.0,
              minVisibleMapPointsInCurrentFrameBA=8,
              localBAProblemSize=16, adjacentSpaceSize=10, maxKeypoints=600,
              pipelinedLocalBA=True, useFrontendSlam=False)


def render_world(n_frames=36, n_landmarks=500, width=640, height=480,
                 seed=0):
    """``bench.render_world``: a textured dot-field world, each landmark
    with its own 11x11 patch."""
    world = make_world(n_frames=n_frames, n_landmarks=n_landmarks, seed=seed,
                       trajectory="line", camera=default_camera(width, height))
    rng = np.random.default_rng(seed + 1)
    patches = rng.integers(40, 255, (n_landmarks, 11, 11)).astype(np.uint8)
    return world, patches


def profile(n_frames=36, n_warm=6, device="cuda"):
    """Returns {fps, prefetch_ms, advance_ms (lists), stats (TimeStats)}
    of the timed frames."""
    import torch

    world, patches = render_world(n_frames=n_frames)

    def make_input(i):
        return MapperInput(
            frame=render_frame(world, patches, i), camera=world.camera,
            track_ids=np.zeros(0, np.int64),
            track_pts=np.zeros((0, 2), np.float32), track_depths=None,
            pose_trail=[Pose(frame_number=j, t=world.times[j],
                             pose_cw=world.odometry_cw[j].copy())
                        for j in range(i, max(-1, i - 6), -1)],
            t=world.times[i])

    def make_mapper():
        return Mapper(Parameters(slam=ParametersSlam(**PARAMS)),
                      device=device)

    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    inputs = [make_input(i) for i in range(n_frames)]
    # throwaway full pass: absorbs every first-use cost, including those
    # that appear mid-sequence as the map grows
    warm_mapper = make_mapper()
    for i in range(n_frames):
        warm_mapper.advance(inputs[i])

    mapper = make_mapper()
    for i in range(n_warm):
        mapper.advance(inputs[i])

    sync()
    stats = timer.enable_timing()
    tp, ta = [], []
    try:
        t_all0 = time.perf_counter()
        for i in range(n_warm, n_frames):
            t0 = time.perf_counter()
            if i + 1 < n_frames:
                mapper.prefetch(inputs[i + 1])
            t1 = time.perf_counter()
            mapper.advance(inputs[i])
            t2 = time.perf_counter()
            tp.append(t1 - t0)
            ta.append(t2 - t1)
        sync()
        dt = time.perf_counter() - t_all0
    finally:
        timer.disable_timing()
    return {"fps": (n_frames - n_warm) / dt,
            "prefetch_ms": [1e3 * x for x in tp],
            "advance_ms": [1e3 * x for x in ta], "stats": stats}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--warm", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = profile(args.frames, args.warm, args.device)
    tp, ta = res["prefetch_ms"], res["advance_ms"]
    print(f"fps={res['fps']:.2f}  prefetch_ms mean={np.mean(tp):.2f} "
          f"p90={np.percentile(tp, 90):.2f}")
    print(f"advance_ms  mean={np.mean(ta):.2f} "
          f"p90={np.percentile(ta, 90):.2f}")
    print(res["stats"].table())


if __name__ == "__main__":
    main()
