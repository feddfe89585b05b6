"""Camera models (vectorized NumPy, host side).

Rebuild of the external ``tracker::Camera`` interface the reference depends on
(SURVEY.md §1 L0; used via pixelToRay / rayToPixel / normalizePixel /
isValidPixel / getFocalLength, e.g. keyframe.cpp:29-31, 340-377).

Design note (TPU-first): all dense optimization kernels operate in the
normalized camera / bearing space (the reference does the same: BA edges use
fx=fy=1 bearings, bundle_adjuster.cpp:43-63), so camera distortion handling
never enters jitted code. The camera lives on host and is vectorized over
point batches with NumPy.

Models:
  - :class:`PinholeCamera` — pinhole with optional radial-tangential
    distortion (k1, k2, p1, p2) — covers EuRoC/KITTI rigs.
  - :class:`KannalaBrandtCamera` — equidistant fisheye with 4 coefficients.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np


class Camera:
    """Interface: all point arguments are arrays shaped (..., 2) or (..., 3)."""

    width: int
    height: int

    def pixel_to_ray(self, pix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Pixel -> unit bearing in camera coords. Returns (bearing, valid)."""
        raise NotImplementedError

    def ray_to_pixel(self, ray: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Camera-coords ray -> pixel. Returns (pixel, valid)."""
        raise NotImplementedError

    def normalize_pixel(self, pix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Pixel -> undistorted normalized image coords (x/z, y/z)."""
        raise NotImplementedError

    def is_valid_pixel(self, pix: np.ndarray, margin: float = 0.0) -> np.ndarray:
        pix = np.asarray(pix)
        x, y = pix[..., 0], pix[..., 1]
        return ((x >= margin) & (y >= margin)
                & (x < self.width - margin) & (y < self.height - margin))

    def get_focal_length(self) -> int:
        raise NotImplementedError

    def serialize(self) -> str:
        raise NotImplementedError

    @staticmethod
    def deserialize(s: str) -> "Camera":
        d = json.loads(s)
        kind = d.pop("kind")
        if kind == "pinhole":
            return PinholeCamera(**d)
        if kind == "kannala_brandt":
            return KannalaBrandtCamera(**d)
        raise ValueError(f"unknown camera kind {kind}")


@dataclasses.dataclass
class PinholeCamera(Camera):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    # radial-tangential distortion; all-zero = ideal pinhole
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2))

    def _distort(self, xn: np.ndarray, yn: np.ndarray):
        if not self.has_distortion:
            return xn, yn
        r2 = xn * xn + yn * yn
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = xn * radial + 2.0 * self.p1 * xn * yn + self.p2 * (r2 + 2.0 * xn * xn)
        yd = yn * radial + self.p1 * (r2 + 2.0 * yn * yn) + 2.0 * self.p2 * xn * yn
        return xd, yd

    def _undistort(self, xd: np.ndarray, yd: np.ndarray, iters: int = 24):
        if not self.has_distortion:
            return xd, yd
        # fixed-point iteration (same scheme as OpenCV undistortPoints)
        xn, yn = xd.copy(), yd.copy()
        for _ in range(iters):
            r2 = xn * xn + yn * yn
            radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
            dx = 2.0 * self.p1 * xn * yn + self.p2 * (r2 + 2.0 * xn * xn)
            dy = self.p1 * (r2 + 2.0 * yn * yn) + 2.0 * self.p2 * xn * yn
            xn = (xd - dx) / radial
            yn = (yd - dy) / radial
        return xn, yn

    def ray_to_pixel(self, ray):
        ray = np.asarray(ray, dtype=np.float64)
        z = ray[..., 2]
        valid = z > 1e-9
        zsafe = np.where(valid, z, 1.0)
        xn = ray[..., 0] / zsafe
        yn = ray[..., 1] / zsafe
        xd, yd = self._distort(xn, yn)
        pix = np.stack([self.fx * xd + self.cx, self.fy * yd + self.cy], axis=-1)
        return pix, valid

    def pixel_to_ray(self, pix):
        pix = np.asarray(pix, dtype=np.float64)
        xd = (pix[..., 0] - self.cx) / self.fx
        yd = (pix[..., 1] - self.cy) / self.fy
        xn, yn = self._undistort(xd, yd)
        ray = np.stack([xn, yn, np.ones_like(xn)], axis=-1)
        ray = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
        valid = np.ones(ray.shape[:-1], dtype=bool)
        return ray, valid

    def normalize_pixel(self, pix):
        pix = np.asarray(pix, dtype=np.float64)
        xd = (pix[..., 0] - self.cx) / self.fx
        yd = (pix[..., 1] - self.cy) / self.fy
        xn, yn = self._undistort(xd, yd)
        return np.stack([xn, yn], axis=-1), np.ones(np.shape(xd), dtype=bool)

    def get_focal_length(self) -> int:
        # reference uses this as an image-scale proxy (mapper_helpers.cpp:571-574)
        return int(round(0.5 * (self.fx + self.fy)))

    def serialize(self) -> str:
        d = dataclasses.asdict(self)
        d["kind"] = "pinhole"
        return json.dumps(d)


@dataclasses.dataclass
class KannalaBrandtCamera(Camera):
    """Equidistant fisheye model: r(theta) = f * (theta + k1 th^3 + k2 th^5 + k3 th^7 + k4 th^9)."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (self.k1 + t2 * (self.k2 + t2 * (self.k3 + t2 * self.k4))))

    def ray_to_pixel(self, ray):
        ray = np.asarray(ray, dtype=np.float64)
        x, y, z = ray[..., 0], ray[..., 1], ray[..., 2]
        r = np.hypot(x, y)
        theta = np.arctan2(r, z)
        valid = theta < np.radians(100.0)  # behind-camera / extreme FOV cut
        theta_d = self._theta_d(theta)
        scale = np.where(r > 1e-12, theta_d / np.maximum(r, 1e-12), 1.0)
        u = self.fx * x * scale + self.cx
        v = self.fy * y * scale + self.cy
        return np.stack([u, v], axis=-1), valid

    def _undistort_theta(self, theta_d, iters: int = 10):
        theta = theta_d.copy()
        for _ in range(iters):
            t2 = theta * theta
            f = theta * (1.0 + t2 * (self.k1 + t2 * (self.k2 + t2 * (self.k3 + t2 * self.k4)))) - theta_d
            df = (1.0 + t2 * (3 * self.k1 + t2 * (5 * self.k2 + t2 * (7 * self.k3 + t2 * 9 * self.k4))))
            theta = theta - f / df
        return theta

    def pixel_to_ray(self, pix):
        pix = np.asarray(pix, dtype=np.float64)
        xd = (pix[..., 0] - self.cx) / self.fx
        yd = (pix[..., 1] - self.cy) / self.fy
        theta_d = np.hypot(xd, yd)
        theta = self._undistort_theta(theta_d)
        scale = np.where(theta_d > 1e-12, np.sin(theta) / np.maximum(theta_d, 1e-12), 1.0)
        z = np.where(theta_d > 1e-12, np.cos(theta), 1.0)
        ray = np.stack([xd * scale, yd * scale, z], axis=-1)
        ray = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
        return ray, np.ones(ray.shape[:-1], dtype=bool)

    def normalize_pixel(self, pix):
        ray, valid = self.pixel_to_ray(pix)
        z = ray[..., 2]
        ok = valid & (z > 1e-9)
        zsafe = np.where(ok, z, 1.0)
        return np.stack([ray[..., 0] / zsafe, ray[..., 1] / zsafe], axis=-1), ok

    def get_focal_length(self) -> int:
        return int(round(0.5 * (self.fx + self.fy)))

    def serialize(self) -> str:
        d = dataclasses.asdict(self)
        d["kind"] = "kannala_brandt"
        return json.dumps(d)


def reproject_to_image(camera: Camera, rot_cw: np.ndarray, trans_cw: np.ndarray,
                       pos_w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World points -> pixels with in-image validity.

    Vectorized equivalent of the reference's ``reprojectToImage``
    (keyframe.cpp:340-356): transform to camera coords, project, and check
    the pixel is inside the image.
    """
    pos_w = np.asarray(pos_w, dtype=np.float64)
    pos_c = pos_w @ rot_cw.T + trans_cw
    pix, valid = camera.ray_to_pixel(pos_c)
    valid = valid & camera.is_valid_pixel(pix)
    return pix, valid


def default_camera(width: int = 752, height: int = 480) -> PinholeCamera:
    """An EuRoC-like ideal pinhole camera, handy for tests and benchmarks."""
    return PinholeCamera(fx=458.0, fy=457.0, cx=width / 2.0, cy=height / 2.0,
                         width=width, height=height)
