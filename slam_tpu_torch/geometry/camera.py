"""Camera models (vectorized NumPy, host side): the port's copy of the parts
of slam_tpu/geometry/camera.py that it calls, same names and layout.

Kept: the camera classes and their fields (``ops/camera.pack_camera`` packs
them for the tensor code), the pinhole ``ray_to_pixel`` and
``is_valid_pixel`` (``utils/synthetic`` renders with them) and
``default_camera``. Left out, because no caller in the port needs them:
``pixel_to_ray``, ``normalize_pixel``, the undistortion iterations,
``get_focal_length``, ``serialize``/``deserialize`` and the Kannala-Brandt
host projection. Copy them from the original when a caller appears.

Models:
  - :class:`PinholeCamera` — pinhole with optional radial-tangential
    distortion (k1, k2, p1, p2) — covers EuRoC/KITTI rigs.
  - :class:`KannalaBrandtCamera` — equidistant fisheye with 4 coefficients.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


class Camera:
    """Interface: all point arguments are arrays shaped (..., 2) or (..., 3)."""

    width: int
    height: int

    def ray_to_pixel(self, ray: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Camera-coords ray -> pixel. Returns (pixel, valid)."""
        raise NotImplementedError

    def is_valid_pixel(self, pix: np.ndarray, margin: float = 0.0) -> np.ndarray:
        pix = np.asarray(pix)
        x, y = pix[..., 0], pix[..., 1]
        return ((x >= margin) & (y >= margin)
                & (x < self.width - margin) & (y < self.height - margin))


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


def default_camera(width: int = 752, height: int = 480) -> PinholeCamera:
    """An EuRoC-like ideal pinhole camera, handy for tests and benchmarks."""
    return PinholeCamera(fx=458.0, fy=457.0, cx=width / 2.0, cy=height / 2.0,
                         width=width, height=height)
