"""ORB orientation and rotated-BRIEF descriptors (port of slam_tpu/ops/orb.py).

Same numerics as the reference extractor: intensity-centroid angle in
degrees via OpenCV's ``fastAtan2`` polynomial, descriptor offsets rotated
with the reference's fast cos/sin and rounded half-to-even, 256 bits packed
LSB-first into eight 32-bit words (carried as int32 bit patterns). The JAX
package gathers patches and samples with one-hot matmuls, a TPU workaround;
here they are plain index gathers. Keypoints carry a leading batch dimension.
On a card, :func:`orb_features` computes every group of keypoints of a frame
step in one launch of the hand-written kernel ``csrc/orb_describe.cu``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from slam_tpu_torch.kernels import launches
from slam_tpu_torch.ops.orb_pattern import ORB_PATTERN

HALF_PATCH = 15          # fast_half_patch_size_
PATCH_RADIUS = 19        # ORB_PATCH_RADIUS: descriptor sampling never leaves this
PATCH_SIZE = 2 * PATCH_RADIUS + 1


@functools.lru_cache(maxsize=1)
def u_max_table() -> np.ndarray:
    """Circular patch bounds."""
    u_max = np.zeros(HALF_PATCH + 1, dtype=np.int64)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        u_max[v] = int(round(np.sqrt(HALF_PATCH * HALF_PATCH - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while u_max[v0] == u_max[v0 + 1]:
            v0 += 1
        u_max[v] = v0
        v0 += 1
    return u_max


@functools.lru_cache(maxsize=1)
def _moment_weights() -> Tuple[np.ndarray, np.ndarray]:
    """(31, 31) masks: W10[dv, du] = du and W01[dv, du] = dv inside the
    circle, so the two moments are dense weighted sums."""
    um = u_max_table()
    n = 2 * HALF_PATCH + 1
    w10 = np.zeros((n, n), dtype=np.float32)
    w01 = np.zeros((n, n), dtype=np.float32)
    for dv in range(-HALF_PATCH, HALF_PATCH + 1):
        d = um[abs(dv)] if dv != 0 else HALF_PATCH
        for du in range(-d, d + 1):
            w10[dv + HALF_PATCH, du + HALF_PATCH] = du
            w01[dv + HALF_PATCH, du + HALF_PATCH] = dv
    return w10, w01


# OpenCV cv::fastAtan2 polynomial constants (modules/core/src/mathfuncs.cpp)
_RAD2DEG = 180.0 / np.pi
_ATAN2_P1 = float(np.float32(0.9997878412794807 * _RAD2DEG))
_ATAN2_P3 = float(np.float32(-0.3258083974640975 * _RAD2DEG))
_ATAN2_P5 = float(np.float32(0.1555786518463281 * _RAD2DEG))
_ATAN2_P7 = float(np.float32(-0.04432655554792128 * _RAD2DEG))
_DBL_EPS = float(np.float32(2.220446049250313e-16))


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2: angle in degrees [0, 360), float32 polynomial."""
    y = y.to(torch.float32)
    x = x.to(torch.float32)
    ax, ay = torch.abs(x), torch.abs(y)
    lo = torch.minimum(ax, ay)
    hi = torch.maximum(ax, ay)
    c = lo / (hi + _DBL_EPS)
    c2 = c * c
    a = ((_ATAN2_P7 * c2 + _ATAN2_P5) * c2 + _ATAN2_P3) * c2 * c + _ATAN2_P1 * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    a = torch.where(y < 0, 360.0 - a, a)
    return a


# Reference fast trig (openvslam/trigonometric.h), float32 throughout.
_PI = float(np.float32(3.14159265358979))
_PI_2 = float(np.float32(np.float32(_PI) / 2.0))
_TWO_PI = float(np.float32(2.0 * np.float32(_PI)))
_INV_TWO_PI = float(np.float32(1.0 / np.float32(_TWO_PI)))
_THREE_PI_2 = float(np.float32(3.0 * np.float32(_PI_2)))


def _cos_core(v):
    v2 = v * v
    return 0.99940307 + v2 * (-0.49558072 + 0.03679168 * v2)


def fast_cos(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.float32)
    v = v - torch.floor(v * _INV_TWO_PI) * _TWO_PI
    v = torch.abs(v)
    return torch.where(
        v < _PI_2, _cos_core(v),
        torch.where(v < _PI, -_cos_core(_PI - v),
                    torch.where(v < _THREE_PI_2, -_cos_core(v - _PI),
                                _cos_core(_TWO_PI - v))))


def fast_sin(v: torch.Tensor) -> torch.Tensor:
    return fast_cos(_PI_2 - v.to(torch.float32))


def extract_patches(img: torch.Tensor, xy: torch.Tensor,
                    radius: int = PATCH_RADIUS) -> torch.Tensor:
    """(S, H, W) images, (S, N, 2) integer keypoints -> (S, N, 2r+1, 2r+1)
    patches. Centres are clamped ``radius`` away from the border; callers
    mask keypoints closer than that."""
    S, h, w = img.shape
    x = torch.clamp(xy[..., 0].to(torch.int64), radius, w - 1 - radius)
    y = torch.clamp(xy[..., 1].to(torch.int64), radius, h - 1 - radius)
    d = torch.arange(-radius, radius + 1, device=img.device)
    rows = (y[..., None] + d)[..., :, None]                   # (S, N, P, 1)
    cols = (x[..., None] + d)[..., None, :]                   # (S, N, 1, P)
    s = torch.arange(S, device=img.device)[:, None, None, None]
    return img[s, rows, cols]


@functools.lru_cache(maxsize=8)
def _device_constants(device: torch.device):
    """(w10, w01, p0, p1) moved to ``device`` once (no per-frame copies)."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (*_moment_weights(), *_pattern_pm()))


def ic_angles(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (degrees) from (..., >=31, >=31)
    patches."""
    c = (patches.shape[-1] - (2 * HALF_PATCH + 1)) // 2
    p31 = patches[..., c:c + 2 * HALF_PATCH + 1, c:c + 2 * HALF_PATCH + 1]
    w10, w01, _, _ = _device_constants(patches.device)
    m10 = torch.sum(p31 * w10, dim=(-2, -1))
    m01 = torch.sum(p31 * w01, dim=(-2, -1))
    return fast_atan2_deg(m01, m10)


@functools.lru_cache(maxsize=1)
def _pattern_pm() -> Tuple[np.ndarray, np.ndarray]:
    """(512,) row and column pattern coordinates: a-samples then b-samples."""
    pat = ORB_PATTERN.astype(np.float32)
    p0 = np.concatenate([pat[:, 0], pat[:, 2]])
    p1 = np.concatenate([pat[:, 1], pat[:, 3]])
    return p0, p1


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool/0-1 -> (..., 8) int32 bit patterns, LSB-first."""
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    words = torch.sum(bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
                      * weights, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def descriptors_from_patches(blur_patches: torch.Tensor,
                             angles_deg: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF over (..., 39, 39) blurred patches -> (..., 8) int32.

    Offsets rotate the learned pairs with the fast cos/sin and round
    half-to-even; bit i is set iff sample_a < sample_b."""
    size = blur_patches.shape[-1]
    radius = (size - 1) // 2
    angle = angles_deg.to(torch.float32) * float(np.float32(np.pi / 180.0))
    ca = fast_cos(angle)[..., None]
    sa = fast_sin(angle)[..., None]
    _, _, p0, p1 = _device_constants(blur_patches.device)
    # row = cvRound(p0*sin + p1*cos); col = cvRound(p0*cos - p1*sin)
    r = torch.round(p0 * sa + p1 * ca).to(torch.int64) + radius
    c = torch.round(p0 * ca - p1 * sa).to(torch.int64) + radius
    flat = blur_patches.flatten(-2)
    vals = torch.gather(flat, -1, r * size + c)                # (..., 512)
    return pack_bits(vals[..., :256] < vals[..., 256:])


def compute_orb(level_img: torch.Tensor, blurred_img: torch.Tensor,
                xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angles (deg) and descriptors for (S, N, 2) integer keypoints on one
    level; both images are quantised to the uint8 grid first."""
    q_img = torch.round(torch.clamp(level_img, 0.0, 255.0))
    q_blur = torch.round(torch.clamp(blurred_img, 0.0, 255.0))
    angles = ic_angles(extract_patches(q_img, xy))
    desc = descriptors_from_patches(extract_patches(q_blur, xy), angles)
    return angles, desc


def orb_features_plain(groups) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`orb_features`: :func:`compute_orb` a
    group, concatenated along the slots."""
    if not groups:
        raise ValueError("orb_features: no group")
    angles, desc = zip(*(compute_orb(*g) for g in groups))
    return torch.cat(angles, 1), torch.cat(desc, 1)


def orb_features(groups) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angles and descriptors of one frame step's keypoints: groups of
    (level, blurred level, (S, N_g, 2) keypoints), each as
    :func:`compute_orb` takes them -> (S, N) float32 degrees and (S, N, 8)
    int32, N the groups' N_g summed, slots in group order.

    CPU tensors (fake ones too) take the plain version; CUDA tensors launch
    the hand-written kernel ``csrc/orb_describe.cu`` once for all groups
    (counted in ``kernels/launches.ORB``, the timer's ``orb.launch``) or
    raise. The kernel replaces no Pallas kernel (the JAX package leaves
    orientation and descriptors to XLA, K3-K6); it is bound by latency and
    gathers, one warp a keypoint reading its moment circle and its 512
    samples once, bit-equal to the plain version."""
    if not groups:
        raise ValueError("orb_features: no group")
    if groups[0][0].device.type == "cpu":
        return orb_features_plain(groups)
    from slam_tpu_torch.kernels import orb_describe as kernel

    angles, desc, launched = kernel.launch(groups)
    launches.ORB.add(launched)
    return angles, desc
