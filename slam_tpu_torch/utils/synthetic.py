"""Synthetic worlds and rendered frames without JAX.

A copy of ``make_world``/``visible_landmarks`` from the JAX package's test
helpers (``tests/synthetic_world.py``: "line" and "loop" trajectories) and
of ``bench.render_frame``, which import the JAX front-end. Known poses,
random landmarks, and frames where each visible landmark splats an 11x11
texture patch. ``default_camera`` is re-exported so that callers take the
camera through the port.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.geometry.camera import default_camera

__all__ = ["SyntheticWorld", "default_camera", "exact_odometry", "make_world",
           "render_frame", "visible_landmarks"]


@dataclasses.dataclass
class SyntheticWorld:
    landmarks: np.ndarray          # (L, 3)
    descriptors: np.ndarray        # (L, 8) uint32
    poses_cw: List[np.ndarray]     # per frame
    times: List[float]
    camera: object
    odometry_cw: List[np.ndarray]  # odometry (noisy) poses per frame


def make_world(n_frames=40, n_landmarks=400, seed=0, trajectory="line",
               odom_noise=0.0, odom_drift=0.0, fps=10.0, camera=None,
               lap_frames=None) -> SyntheticWorld:
    rng = np.random.default_rng(seed)
    camera = camera or default_camera(640, 480)

    if trajectory == "line":
        centers = [np.array([0.12 * i, 0.0, 0.0]) for i in range(n_frames)]
        yaws = [0.0] * n_frames
        lows, highs = [-2, -2, 2.0], [0.12 * n_frames + 2, 2, 8.0]
    elif trajectory == "loop":
        # square loop in the x-z plane; frames beyond one lap (lap_frames)
        # revisit the start of the loop with identical poses
        per_side = (lap_frames or n_frames) // 4
        centers, yaws = [], []
        side_len = 0.15 * per_side
        heading = [0.0, np.pi / 2, np.pi, 3 * np.pi / 2]
        corners = [np.array([0.0, 0.0, 0.0]),
                   np.array([side_len, 0.0, 0.0]),
                   np.array([side_len, 0.0, side_len]),
                   np.array([0.0, 0.0, side_len])]
        for i in range(n_frames):
            j = i % (4 * per_side)
            side = j // per_side
            frac = (j - side * per_side) / per_side
            d = heading[side]
            step = np.array([np.cos(d), 0.0, np.sin(d)]) * side_len * frac
            centers.append(corners[side] + step)
            yaws.append(d)
        lows, highs = [-4, -2, -4], [side_len + 4, 2, side_len + 4]
    else:
        raise ValueError(trajectory)

    landmarks = rng.uniform(lows, highs, (n_landmarks, 3))
    descriptors = rng.integers(0, 2 ** 32, (n_landmarks, 8), dtype=np.uint32)

    poses_cw = []
    for c, yaw in zip(centers, yaws):
        R_cw = se3.so3_exp(np.array([0.0, yaw, 0.0])).T
        T = np.eye(4)
        T[:3, :3] = R_cw
        T[:3, 3] = -R_cw @ c
        poses_cw.append(T)

    # odometry: true pose perturbed by noise and accumulating drift
    odometry_cw = []
    drift = np.zeros(3)
    for T in poses_cw:
        drift = drift + rng.normal(0, odom_drift, 3)
        xi = np.concatenate([rng.normal(0, odom_noise, 3),
                             rng.normal(0, odom_noise, 3) + drift])
        odometry_cw.append(se3.se3_exp(xi) @ T)

    times = [i / fps for i in range(n_frames)]
    return SyntheticWorld(landmarks, descriptors, poses_cw, times, camera,
                          odometry_cw)


def visible_landmarks(world: SyntheticWorld, frame: int, margin=20.0):
    T = world.poses_cw[frame]
    pc = world.landmarks @ T[:3, :3].T + T[:3, 3]
    pix, ok = world.camera.ray_to_pixel(pc)
    ok = ok & world.camera.is_valid_pixel(pix, margin=margin) & (pc[:, 2] > 0.5)
    return np.where(ok)[0], pix


def render_frame(world: SyntheticWorld, patches: np.ndarray, frame: int,
                 width=640, height=480) -> np.ndarray:
    """(H, W) uint8 frame: each visible landmark splats its 11x11 patch."""
    img = np.full((height, width), 20, np.uint8)
    vis, pix = visible_landmarks(world, frame, margin=8.0)
    for li in vis:
        x, y = int(round(pix[li, 0])), int(round(pix[li, 1]))
        y0, y1 = max(0, y - 5), min(height, y + 6)
        x0, x1 = max(0, x - 5), min(width, x + 6)
        img[y0:y1, x0:x1] = patches[li][:y1 - y0, :x1 - x0]
    return img


def exact_odometry(world: SyntheticWorld, n_frames: int) -> np.ndarray:
    """(T, 4, 4) float32 deltas cam_t <- cam_{t-1} from the ground truth
    (identity first)."""
    return np.stack(
        [np.eye(4, dtype=np.float32)]
        + [(world.poses_cw[i] @ np.linalg.inv(world.poses_cw[i - 1]))
           .astype(np.float32) for i in range(1, n_frames)])
