"""Image pyramid as band-matrix matmuls (port of slam_tpu/ops/pyramid.py).

Bilinear resize and the separable 7x7 sigma=2 Gaussian blur
(BORDER_REFLECT_101) are linear row/column operators, so each level is
``Rows @ img @ Cols^T``. Every level is quantised back to the uint8 grid
(rint + clip) like the reference's uint8 levels, and the next level is
resized from the quantised one. The matmuls must run in full f32: under TF32
the rint results flip (see ``slam_tpu_torch/precision.py``).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from slam_tpu_torch.precision import pin_full_f32


def level_sizes(width: int, height: int, scale_factors: Sequence[float]
                ) -> List[Tuple[int, int]]:
    """Per-level (width, height): round(full_size / cumulative_scale)."""
    return [(int(round(width / float(s))), int(round(height / float(s))))
            for s in scale_factors]


def _bilinear_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear operator with half-pixel centres and edge
    clamping (OpenCV INTER_LINEAR's float path)."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        frac = src - i0
        i0c = min(max(i0, 0), n_in - 1)
        i1c = min(max(i0 + 1, 0), n_in - 1)
        A[i, i0c] += 1.0 - frac
        A[i, i1c] += frac
    return A


def gaussian_kernel_1d(width: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Normalized 1-D Gaussian taps."""
    x = np.arange(width, dtype=np.float64) - (width - 1) * 0.5
    k = np.exp(-0.5 * x * x / (sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur_matrix(n: int, taps: np.ndarray) -> np.ndarray:
    """(n, n) banded operator applying 1-D taps with BORDER_REFLECT_101."""
    half = len(taps) // 2
    A = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for t, w in enumerate(taps):
            j = i + t - half
            if j < 0:
                j = -j
            elif j >= n:
                j = 2 * (n - 1) - j
            j = min(max(j, 0), n - 1)
            A[i, j] += w
    return A


@functools.lru_cache(maxsize=8)
def pyramid_operators(width: int, height: int, scale_key: tuple):
    """All band matrices of one image geometry, as NumPy arrays:
    (sizes, resize (rows, cols) per level >= 1, blur (rows, cols) per
    level)."""
    sizes = level_sizes(width, height, scale_key)
    taps = gaussian_kernel_1d()
    resize_ops, blur_ops = [], []
    for lvl, (w, h) in enumerate(sizes):
        if lvl > 0:
            pw, ph = sizes[lvl - 1]
            resize_ops.append((_bilinear_matrix(h, ph), _bilinear_matrix(w, pw)))
        blur_ops.append((_blur_matrix(h, taps), _blur_matrix(w, taps)))
    return sizes, resize_ops, blur_ops


def quantise(x: torch.Tensor) -> torch.Tensor:
    """Pixels rounded to the uint8 grid, as float32."""
    return torch.round(torch.clamp(x, 0.0, 255.0))


def build_pyramid(image: torch.Tensor, resize_ops, blur_ops):
    """(..., H, W) float32 image -> (levels, blurred), lists of (..., H_l,
    W_l) float32 tensors on the uint8 grid. ``resize_ops``/``blur_ops`` are
    (rows, cols) tensor pairs on the image's device."""
    levels = [image]
    for rows, cols in resize_ops:
        levels.append(quantise(rows @ levels[-1] @ cols.T))
    blurred = [quantise(g_rows @ lvl @ g_cols.T)
               for (g_rows, g_cols), lvl in zip(blur_ops, levels)]
    return levels, blurred


@functools.lru_cache(maxsize=8)
def device_operators(width: int, height: int, scale_key: tuple,
                     device: torch.device):
    """:func:`pyramid_operators` with the band matrices moved to ``device``
    once: (sizes, resize (rows, cols) tensor pairs, blur pairs)."""
    sizes, resize_np, blur_np = pyramid_operators(width, height, scale_key)

    def put(pairs):
        return [(torch.from_numpy(r).to(device), torch.from_numpy(c).to(device))
                for r, c in pairs]
    return sizes, put(resize_np), put(blur_np)


class ImagePyramid:
    """Pyramid builder for a fixed image geometry, the reference's
    ``ImagePyramid`` interface (image_pyramid.hpp:16-30): ``update()``
    recomputes the levels for a new frame; ``levels``/``blurred`` hold the
    plain and blurred (H_l, W_l) float32 images per level on ``device``."""

    def __init__(self, settings, width: int, height: int, device="cuda"):
        self.scale_factors = tuple(float(s) for s in settings.scaleFactors)
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.sizes, self._resize_ops, self._blur_ops = device_operators(
            width, height, self.scale_factors, self.device)
        self.levels: List[torch.Tensor] = []
        self.blurred: List[torch.Tensor] = []

    def update(self, image) -> "ImagePyramid":
        """Build the levels of an (H, W) image (NumPy or tensor)."""
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image))
        img = image.to(device=self.device, dtype=torch.float32)
        if tuple(img.shape) != (self.height, self.width):
            raise ValueError(f"image {tuple(img.shape)}, pyramid built for "
                             f"{(self.height, self.width)}")
        pin_full_f32()
        self.levels, self.blurred = build_pyramid(img, self._resize_ops,
                                                  self._blur_ops)
        return self

    @property
    def num_levels(self) -> int:
        return len(self.sizes)
