"""ORB front-end: pyramid + detection + orientation + descriptors (port of
slam_tpu/ops/frontend.py ``_extract_impl``).

One call extracts features for a batch of S frames into fixed-layout
padded tensors. Slot layout along the keypoint axis:

    [0, n_tracked)                        tracked-keypoint slots
    [n_tracked + sum(budgets[:l]), ...)   level-l detected slots

with a validity mask; invalid slots hold deterministic filler and must be
ignored. The fused BoW-words branch (``vocab_size > 0``) is not ported.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from slam_tpu_torch.ops import detector as det
from slam_tpu_torch.ops import orb
from slam_tpu_torch.ops.pyramid import build_pyramid, pyramid_operators
from slam_tpu_torch.params import ORB_PATCH_RADIUS, StaticSettings


class FrontendSpec(NamedTuple):
    """Static extraction settings (the JAX package's ``spec`` tuple)."""
    scale_factors: Tuple[float, ...]
    budgets: Tuple[int, ...]
    min_dists: Tuple[int, ...]
    lk_level: int
    use_fast: bool
    width: int
    height: int


class Features(NamedTuple):
    pts: torch.Tensor       # (S, N, 2) float32, full-resolution pixels
    octave: torch.Tensor    # (S, N) int32 pyramid level
    angle: torch.Tensor     # (S, N) float32 degrees
    desc: torch.Tensor      # (S, N, 8) int32 descriptor bit patterns
    valid: torch.Tensor     # (S, N) bool


def min_distances(settings: StaticSettings, sizes) -> List[int]:
    """Per-level GFTT min distance (reference: feature_detector.cpp:79-82)."""
    out = []
    for (w, h) in sizes:
        su = min(w, h) / 720.0 * 0.8
        out.append(int(np.floor(settings.parameters.slam.gfttMinDistance
                                * su + 0.5)))
    return out


@functools.lru_cache(maxsize=8)
def _operators(spec: FrontendSpec, device: torch.device):
    """Band matrices of one geometry, moved to ``device`` once."""
    sizes, resize_np, blur_np = pyramid_operators(spec.width, spec.height,
                                                  spec.scale_factors)

    def put(pairs):
        return [(torch.from_numpy(r).to(device), torch.from_numpy(c).to(device))
                for r, c in pairs]
    return sizes, put(resize_np), put(blur_np)


def extract(image: torch.Tensor, tracked_xy: torch.Tensor,
            tracked_valid: torch.Tensor, spec: FrontendSpec) -> Features:
    """(S, H, W) images, (S, T, 2) tracked points, (S, T) validity ->
    :class:`Features` with N = T + sum(budgets) slots per frame. On a card
    the caller pins full f32 first (``slam_tpu_torch/precision.py``)."""
    sizes, resize_ops, blur_ops = _operators(spec, image.device)
    levels, blurred = build_pyramid(image.to(torch.float32), resize_ops,
                                    blur_ops)
    return extract_from_pyramid(levels, blurred, sizes, tracked_xy,
                                tracked_valid, spec)


def extract_from_pyramid(levels, blurred, sizes, tracked_xy: torch.Tensor,
                         tracked_valid: torch.Tensor, spec: FrontendSpec
                         ) -> Features:
    """Detection, orientation and descriptors on a built pyramid (lists of
    (S, H_l, W_l) level and blurred-level images)."""
    S = levels[0].shape[0]
    dev = levels[0].device
    out_pts, out_oct, out_ang, out_desc, out_valid = [], [], [], [], []

    # tracked keypoints at the fixed LK level
    lk = spec.lk_level
    lk_scale = float(np.float32(spec.scale_factors[lk]))
    lk_w, lk_h = sizes[lk]
    xi = torch.round(tracked_xy[..., 0] / lk_scale)
    yi = torch.round(tracked_xy[..., 1] / lk_scale)
    margin = ORB_PATCH_RADIUS
    t_ok = (tracked_valid & (xi >= margin) & (yi >= margin)
            & (xi < lk_w - margin) & (yi < lk_h - margin))
    t_ang, t_desc = orb.compute_orb(levels[lk], blurred[lk],
                                    torch.stack([xi, yi], dim=-1))
    out_pts.append(tracked_xy)
    out_oct.append(torch.full(t_ok.shape, lk, dtype=torch.int32, device=dev))
    out_ang.append(t_ang)
    out_desc.append(t_desc)
    out_valid.append(t_ok)

    # detected keypoints per level
    for lvl, (lvl_img, lvl_blur) in enumerate(zip(levels, blurred)):
        budget = spec.budgets[lvl]
        if budget <= 0:
            continue
        q = torch.round(torch.clamp(lvl_img, 0.0, 255.0))
        resp = det.fast_response(q) if spec.use_fast \
            else det.shi_tomasi_response(q)
        xy, _, valid = det.select_keypoints(resp, budget, spec.min_dists[lvl])
        ang, desc = orb.compute_orb(lvl_img, lvl_blur, xy)
        out_pts.append(xy * float(np.float32(spec.scale_factors[lvl])))
        out_oct.append(torch.full((S, budget), lvl, dtype=torch.int32,
                                  device=dev))
        out_ang.append(ang)
        out_desc.append(desc)
        out_valid.append(valid)

    return Features(torch.cat(out_pts, 1), torch.cat(out_oct, 1),
                    torch.cat(out_ang, 1), torch.cat(out_desc, 1),
                    torch.cat(out_valid, 1))
