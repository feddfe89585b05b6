"""Corner responses and static-budget keypoint selection (port of
slam_tpu/ops/detector.py).

Dense Shi-Tomasi (GFTT) or FAST-9/16 response maps, a max-pool grid NMS whose
window enforces the minimum distance, a 19 px margin, and the per-level
budget taken as the first ``budget`` entries of a stable descending sort:
``jax.lax.top_k`` returns tied scores lowest index first and ``torch.topk``
does not promise that. Images carry a leading batch dimension. On a card,
GFTT detection of all levels of a step (quantisation, response, peak test
and margin) is one launch of the hand-written kernel behind
:func:`gftt_peaks`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from slam_tpu_torch.kernels import launches
from slam_tpu_torch.ops.pyramid import quantise
from slam_tpu_torch.params import ORB_PATCH_RADIUS


def _pad_edge(img: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(img, (p, p, p, p), mode="replicate")


def shi_tomasi_response(img: torch.Tensor) -> torch.Tensor:
    """(S, H, W) -> (S, H, W) min-eigenvalue corner response: 3x3 Sobel
    gradients and a 3x3 box window."""
    img = img.to(torch.float32)

    def sep(img, kr, kc):
        p = _pad_edge(img, 1)
        rows = (kr[0] * p[..., :-2, :] + kr[1] * p[..., 1:-1, :]
                + kr[2] * p[..., 2:, :])
        return (kc[0] * rows[..., :, :-2] + kc[1] * rows[..., :, 1:-1]
                + kc[2] * rows[..., :, 2:])

    gx = sep(img, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0))
    gy = sep(img, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0))

    def box3(a):
        p = _pad_edge(a, 1)
        return (p[..., :-2, :-2] + p[..., :-2, 1:-1] + p[..., :-2, 2:]
                + p[..., 1:-1, :-2] + p[..., 1:-1, 1:-1] + p[..., 1:-1, 2:]
                + p[..., 2:, :-2] + p[..., 2:, 1:-1] + p[..., 2:, 2:])

    gxx = box3(gx * gx)
    gyy = box3(gy * gy)
    gxy = box3(gx * gy)
    tr = gxx + gyy
    # On uint8-grid images every term above is an integer below 2^24, so
    # exact in f32; the discriminant is where rounding starts. The JAX
    # reference's compiled CPU program forms it as a fused multiply-add of
    # 4 gxy * gxy onto the rounded (gxx - gyy)^2. That float64 sum is exact,
    # so one rounding to f32 reproduces it bit for bit, and ties between
    # corner scores break the same way in both packages.
    disc = (((gxx - gyy) ** 2).double()
            + (4.0 * gxy).double() * gxy.double()).float()
    # correctly rounded f32 square root (torch's vectorised CPU sqrt is not
    # always): the square root of a float32, taken in float64, rounds right
    det_part = torch.sqrt(torch.clamp(disc, min=0.0).double()).float()
    return 0.5 * (tr - det_part)


# FAST-9/16 Bresenham circle offsets (row, col), radius 3
_FAST_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)


def fast_response(img: torch.Tensor, threshold: float = 10.0) -> torch.Tensor:
    """(S, H, W) -> (S, H, W) FAST-9/16 score: summed |difference| over the
    qualifying circle pixels where >= 9 contiguous pixels are all brighter
    or all darker than centre +/- threshold, else 0."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    p = _pad_edge(img, 3)
    circle = torch.stack([p[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                          for dy, dx in _FAST_OFFSETS], dim=-3)  # (S,16,H,W)
    center = img[..., None, :, :]
    bright = circle > center + threshold
    dark = circle < center - threshold

    def has_run9(mask):
        acc = mask
        for k in range(1, 9):
            acc = acc & torch.roll(mask, -k, dims=-3)
        return torch.any(acc, dim=-3)

    is_corner = has_run9(bright) | has_run9(dark)
    diff = torch.abs(circle - center) - threshold
    zero = torch.zeros_like(diff)
    score_b = torch.sum(torch.where(bright, diff, zero), dim=-3)
    score_d = torch.sum(torch.where(dark, diff, zero), dim=-3)
    return torch.where(is_corner, torch.maximum(score_b, score_d),
                       torch.zeros_like(score_b))


def peak_map(response: torch.Tensor, min_distance: int,
             margin: int = ORB_PATCH_RADIUS) -> torch.Tensor:
    """(S, H, W) response -> (S, H, W) masked map: the response where the
    pixel is the maximum of its (2*min_distance+1)^2 neighbourhood, above 0
    and inside the margin, else -inf."""
    S, h, w = response.shape
    md = max(int(min_distance), 1)
    pooled = F.max_pool2d(response[:, None], kernel_size=2 * md + 1,
                          stride=1, padding=md)[:, 0]
    is_peak = (response >= pooled) & (response > 0.0)
    row = torch.arange(h, device=response.device)[:, None]
    col = torch.arange(w, device=response.device)[None, :]
    in_margin = ((row >= margin) & (row < h - margin)
                 & (col >= margin) & (col < w - margin))
    return torch.where(is_peak & in_margin, response,
                       torch.full_like(response, -float("inf")))


def take_best(masked: torch.Tensor, budget: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, H, W) masked map -> xy (S, budget, 2) float32, score (S, budget),
    valid (S, budget) bool: the first ``budget`` pixels of a stable
    descending sort."""
    S, h, w = masked.shape
    scores, idx = torch.sort(masked.reshape(S, -1), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :budget], idx[:, :budget]
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    valid = torch.isfinite(scores) & (scores > 0.0)
    xy = torch.stack([xs, ys], dim=-1)
    return xy, torch.where(valid, scores, torch.zeros_like(scores)), valid


def select_keypoints(response: torch.Tensor, budget: int, min_distance: int,
                     margin: int = ORB_PATCH_RADIUS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, H, W) response -> xy (S, budget, 2) float32, score (S, budget),
    valid (S, budget) bool. A selected pixel is the maximum of its
    (2*min_distance+1)^2 neighbourhood and lies inside the margin."""
    return take_best(peak_map(response, min_distance, margin), budget)


def gftt_peaks_plain(levels, min_dists, margin: int = ORB_PATCH_RADIUS):
    """The plain version of :func:`gftt_peaks`: per level, the quantised
    image's Shi-Tomasi response through :func:`peak_map`."""
    return [peak_map(shi_tomasi_response(quantise(img)), md, margin)
            for img, md in zip(levels, min_dists)]


def gftt_peaks(levels, min_dists, margin: int = ORB_PATCH_RADIUS):
    """GFTT detection of one frame step: (S, H_l, W_l) float32 levels and
    their min distances -> the (S, H_l, W_l) masked maps that
    :func:`take_best` sorts.

    CPU tensors (fake tensors included) take the plain version; CUDA
    tensors launch the hand-written kernel ``csrc/gftt_peaks.cu`` once for
    all levels (counted in ``kernels/launches.GFTT``, the timer's
    ``detect.launch``) or raise. The kernel replaces no Pallas kernel (the
    JAX package leaves detection to XLA, K3-K6); it is bound by bytes,
    reading each level once and writing its map once, and keeps the
    gradients, products, box sums and response out of device memory
    (shared memory over tiles with a halo), bit-equal to the plain
    version."""
    if not levels:
        return []
    if levels[0].device.type == "cpu":
        return gftt_peaks_plain(levels, min_dists, margin)
    from slam_tpu_torch.kernels import gftt_peaks as kernel

    maps, launched = kernel.launch(
        [t.to(torch.float32).contiguous() for t in levels],
        [max(int(md), 1) for md in min_dists], margin)
    launches.GFTT.add(launched)
    return maps
