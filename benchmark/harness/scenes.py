"""Rendered scenes, trajectories and drifted odometry, made from the seed.

The benchmark's copy of the rendered-sequence tools' scene code
(``tools/run_euroc_synthetic.py``: the EuRoC-class room;
``tools/run_kitti_synthetic.py``: the KITTI-class street), rewritten in
plain torch so that textures and frames are made on the card in a few large
calls. A configuration file names the scene (``scene.kind``) and its
numbers; nothing here knows a configuration by name.

Geometry runs in float64, as the NumPy ray caster's does; a frame is
``uint8`` (H, W). ``benchmark/tests/test_bench_scenes.py`` holds the
renderer to the tools' NumPy one on shared textures.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class Camera:
    """Pinhole intrinsics of a configuration (no distortion: the scenes
    render undistorted, so renderer and pipeline share one model)."""

    def __init__(self, d: dict):
        self.fx, self.fy = float(d["fx"]), float(d["fy"])
        self.cx, self.cy = float(d["cx"]), float(d["cy"])
        self.width, self.height = int(d["width"]), int(d["height"])


def _room_planes(room):
    hx, hy, hz = room[0] / 2, room[1] / 2, room[2] / 2
    # (axis, plane value, u-axis, v-axis, u half-extent, v half-extent)
    return [(0, -hx, 2, 1, hz, hy), (0, hx, 2, 1, hz, hy),
            (1, -hy, 0, 2, hx, hz), (1, hy, 0, 2, hx, hz),
            (2, -hz, 0, 1, hx, hy), (2, hz, 0, 1, hx, hy)]


def _street_planes(outer, inner, wall_h):
    hy = wall_h / 2.0
    planes = []
    for half in (outer, inner):          # outer ring faces in, block out
        for ax in (0, 2):
            for sgn in (-1.0, 1.0):
                planes.append((ax, sgn * half, 2 - ax, 1, half, hy))
    planes.append((1, hy, 0, 2, outer, outer))       # ground (y down)
    return planes


def _blocks_texture(gen, n_blocks, lo, hi, tex_size, noise, device):
    """Coarse random blocks (corners at every block edge) plus fine noise
    (descriptor distinctiveness), clipped to [0, 255]."""
    blocks = torch.randint(lo, hi, (n_blocks, n_blocks), generator=gen,
                           device=device).to(torch.float32)
    reps = -(-tex_size // n_blocks)
    coarse = blocks.repeat_interleave(reps, 0).repeat_interleave(reps, 1)
    coarse = coarse[:tex_size, :tex_size]
    fine = torch.randn((tex_size, tex_size), generator=gen, device=device,
                       dtype=torch.float32) * noise
    return torch.clamp(coarse + fine, 0, 255)


def make_scene(scene: dict, seed: int, device) -> tuple:
    """(textures, planes) of ``scene`` (a configuration's ``scene``
    group), textures drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tex_size = int(scene["tex_size"])
    if scene["kind"] == "room":
        planes = _room_planes(scene["room"])
        textures = [_blocks_texture(gen, 64, 30, 226, tex_size, 12.0, device)
                    for _ in planes]
    elif scene["kind"] == "street":
        planes = _street_planes(scene["outer"], scene["inner"],
                                scene["wall_h"])
        textures = []
        for plane in planes:
            n_blocks = int(np.clip(2 * plane[4] / scene["block_m"], 16, 512))
            textures.append(_blocks_texture(gen, n_blocks, 25, 231, tex_size,
                                            10.0, device))
    else:
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    return textures, planes


def pixel_dirs(cam: Camera, device) -> torch.Tensor:
    """(H, W, 3) float64 camera-frame rays through pixel centres."""
    v, u = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float64, device=device) + 0.5,
        torch.arange(cam.width, dtype=torch.float64, device=device) + 0.5,
        indexing="ij")
    return torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                        torch.ones_like(u)], dim=-1)


def cast(planes, center, dirs):
    """Nearest plane hit of world rays ``dirs`` (B, ..., 3) from
    ``center`` (B, 3): (t, plane index, u, v); t is inf where no plane."""
    shape = dirs.shape[:-1]
    c = center.reshape((center.shape[0],) + (1,) * (dirs.dim() - 2) + (3,))
    best_t = torch.full(shape, math.inf, dtype=dirs.dtype, device=dirs.device)
    best_k = torch.full(shape, -1, dtype=torch.int64, device=dirs.device)
    best_u = torch.zeros(shape, dtype=dirs.dtype, device=dirs.device)
    best_v = torch.zeros_like(best_u)
    for k, (ax, val, ua, va, ue, ve) in enumerate(planes):
        t = (val - c[..., ax]) / dirs[..., ax]
        pu = c[..., ua] + t * dirs[..., ua]
        pv = c[..., va] + t * dirs[..., va]
        hit = ((t > 1e-6) & (pu.abs() <= ue) & (pv.abs() <= ve)
               & (t < best_t))
        best_t = torch.where(hit, t, best_t)
        best_k = torch.where(hit, torch.full_like(best_k, k), best_k)
        best_u = torch.where(hit, pu, best_u)
        best_v = torch.where(hit, pv, best_v)
    return best_t, best_k, best_u, best_v


def render(scene, poses_cw: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Ray-cast ``scene`` through (B, 4, 4) float64 world-to-camera poses:
    (B, H, W) uint8 frames with mild distance shading, bilinear texture
    lookup as the tools' ``render``."""
    textures, planes = scene
    R = poses_cw[:, :3, :3]
    center = -(R.transpose(1, 2) @ poses_cw[:, :3, 3:])[..., 0]
    wd = torch.einsum("hwj,bjk->bhwk", dirs, R)        # rays in the world
    t, k, pu, pv = cast(planes, center, wd)
    img = torch.zeros(t.shape, dtype=torch.float64, device=t.device)
    for i, (tex, (_, _, _, _, ue, ve)) in enumerate(zip(textures, planes)):
        hit = k == i
        ts_v, ts_u = tex.shape
        tu = (pu + ue) / (2 * ue) * (ts_u - 1)
        tv = (pv + ve) / (2 * ve) * (ts_v - 1)
        tu = torch.where(hit, tu, torch.zeros_like(tu))
        tv = torch.where(hit, tv, torch.zeros_like(tv))
        iu, iv = tu.to(torch.int64), tv.to(torch.int64)
        fu, fv = tu - iu, tv - iv
        iu1 = torch.clamp(iu + 1, max=ts_u - 1)
        iv1 = torch.clamp(iv + 1, max=ts_v - 1)
        flat = tex.reshape(-1).to(torch.float64)
        val = (flat[iv * ts_u + iu] * (1 - fu) * (1 - fv)
               + flat[iv * ts_u + iu1] * fu * (1 - fv)
               + flat[iv1 * ts_u + iu] * (1 - fu) * fv
               + flat[iv1 * ts_u + iu1] * fu * fv)
        shade = 1.0 / (1.0 + 0.06 * t)
        img = torch.where(hit, (val * shade).to(torch.float32)
                          .to(torch.float64), img)
    return torch.clamp(img, 0, 255).to(torch.uint8)


def circle_poses_cw(phases: np.ndarray, radius: float, y: float = 0.0
                    ) -> np.ndarray:
    """(N, 4, 4) cameras on a circle in the xz-plane looking along the
    direction of travel (CV convention: z forward, y down)."""
    out = np.zeros((len(phases), 4, 4))
    for i, ph in enumerate(phases):
        c = np.array([radius * np.cos(ph), y, radius * np.sin(ph)])
        fwd = np.array([-np.sin(ph), 0.0, np.cos(ph)])
        down = np.array([0.0, -1.0, 0.0])
        R_wc = np.stack([np.cross(down, fwd), down, fwd], axis=1)
        out[i, :3, :3] = R_wc.T
        out[i, :3, 3] = -R_wc.T @ c
        out[i, 3, 3] = 1.0
    return out


def trajectory(traj: dict, n_frames: int) -> tuple:
    """(times (N,), truth poses_cw (N, 4, 4)) of a configuration's
    ``trajectory`` group: a circle of ``radius`` at ``step_rad`` a frame,
    at ``fps``."""
    times = np.arange(n_frames) / float(traj["fps"])
    phases = np.arange(n_frames) * float(traj["step_rad"])
    return times, circle_poses_cw(phases, float(traj["radius"]))


def _se3_exp_translation(t):
    T = np.eye(4)
    T[:3, 3] = t
    return T


def drifted_odometry(poses_cw: np.ndarray, drift: float, drift_yaw: float,
                     rng: np.random.Generator) -> np.ndarray:
    """(N, 4, 4) odometry poses as the tools make them: a translation
    random walk of ``drift`` m a frame composed onto the truth, and the
    world turned about the up axis by ``drift_yaw`` rad a frame."""
    walk = np.cumsum(rng.normal(0.0, drift, (len(poses_cw), 3)), axis=0)
    out = np.empty_like(poses_cw)
    for i, p in enumerate(poses_cw):
        ang = drift_yaw * i
        c, s = np.cos(ang), np.sin(ang)
        yaw_inv = np.eye(4)
        yaw_inv[0, 0] = yaw_inv[2, 2] = c
        yaw_inv[0, 2], yaw_inv[2, 0] = -s, s
        out[i] = _se3_exp_translation(walk[i]) @ p @ yaw_inv
    return out


def odometry_deltas(odo_cw: np.ndarray) -> np.ndarray:
    """(N, 4, 4) float32 motion priors cam_t <- cam_{t-1} (identity
    first), the device VO's input."""
    d = [np.eye(4)] + [odo_cw[i] @ np.linalg.inv(odo_cw[i - 1])
                       for i in range(1, len(odo_cw))]
    return np.stack(d).astype(np.float32)


def render_frames(scene, poses_cw: np.ndarray, cam: Camera, device,
                  batch: int = 32) -> np.ndarray:
    """(N, H, W) uint8 frames on the host, rendered ``batch`` at a time on
    ``device``."""
    dirs = pixel_dirs(cam, device)
    out = np.empty((len(poses_cw), cam.height, cam.width), np.uint8)
    for s in range(0, len(poses_cw), batch):
        p = torch.from_numpy(poses_cw[s:s + batch]).to(device)
        out[s:s + batch] = render(scene, p, dirs).cpu().numpy()
    return out
