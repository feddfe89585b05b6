"""Camera projection and unprojection on tensors (port of
slam_tpu/ops/camera_jax.py).

Parameters are packed into a flat float32 vector (:func:`pack_camera`) so one
code path serves any camera of a given kind.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from slam_tpu_torch.geometry.camera import (Camera, KannalaBrandtCamera,
                                            PinholeCamera)


def pack_camera(cam: Camera) -> Tuple[str, np.ndarray]:
    """Camera -> (kind, packed float32 params)."""
    if isinstance(cam, PinholeCamera):
        return "pinhole", np.array(
            [cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
             cam.k1, cam.k2, cam.p1, cam.p2], np.float32)
    if isinstance(cam, KannalaBrandtCamera):
        return "kannala_brandt", np.array(
            [cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
             cam.k1, cam.k2, cam.k3, cam.k4], np.float32)
    raise TypeError(type(cam))


def project(kind: str, params: torch.Tensor, pts: torch.Tensor):
    """(..., 3) camera-frame points -> ((..., 2) pixels, (...,) valid).

    Valid = in front of the camera and inside the image bounds."""
    fx, fy, cx, cy, w, h = (params[i] for i in range(6))
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    if kind == "pinhole":
        k1, k2, p1, p2 = (params[i] for i in range(6, 10))
        front = z > 1e-9
        zs = torch.where(front, z, torch.ones_like(z))
        xn = x / zs
        yn = y / zs
        r2 = xn * xn + yn * yn
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
        yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
        u = fx * xd + cx
        v = fy * yd + cy
        valid = front
    elif kind == "kannala_brandt":
        k1, k2, k3, k4 = (params[i] for i in range(6, 10))
        r = torch.hypot(x, y)
        theta = torch.atan2(r, z)
        t2 = theta * theta
        theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = torch.where(r > 1e-12, theta_d / torch.clamp(r, min=1e-12),
                            torch.ones_like(r))
        u = fx * x * scale + cx
        v = fy * y * scale + cy
        valid = theta < math.radians(100.0)
    else:
        raise ValueError(kind)
    valid = valid & (u >= 0) & (v >= 0) & (u < w) & (v < h)
    return torch.stack([u, v], dim=-1), valid


def unproject(kind: str, params: torch.Tensor, pix: torch.Tensor):
    """(..., 2) pixels -> (..., 3) unit bearing vectors.

    Pinhole distortion is inverted with five fixed-point iterations;
    Kannala-Brandt inverts theta_d -> theta with five Newton steps."""
    fx, fy, cx, cy = (params[i] for i in range(4))
    u, v = pix[..., 0], pix[..., 1]
    xn = (u - cx) / fx
    yn = (v - cy) / fy
    if kind == "pinhole":
        k1, k2, p1, p2 = (params[i] for i in range(6, 10))
        x, y = xn, yn
        for _ in range(5):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xn - dx) / radial
            y = (yn - dy) / radial
        b = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    elif kind == "kannala_brandt":
        k1, k2, k3, k4 = (params[i] for i in range(6, 10))
        theta_d = torch.hypot(xn, yn)
        theta = theta_d
        for _ in range(5):
            t2 = theta * theta
            f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
            df = (1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2
                  + t2 * (7.0 * k3 + t2 * 9.0 * k4))))
            theta = theta - f / torch.clamp(df, min=1e-6)
        scale = torch.where(theta_d > 1e-12,
                            torch.sin(theta) / torch.clamp(theta_d, min=1e-12),
                            torch.ones_like(theta_d))
        b = torch.stack([xn * scale, yn * scale,
                         torch.cos(theta) * torch.ones_like(xn)], dim=-1)
    else:
        raise ValueError(kind)
    return b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True),
                           min=1e-12)
