"""Hamming distance between 256-bit ORB descriptors as a matmul (port of
slam_tpu/ops/hamming.py).

Descriptors travel as (..., 8) int32 tensors holding the bit pattern of the
reference's uint32 words (torch cannot right-shift uint32 on the CPU). With
the bits unpacked to +/-1,

    hamming(a, b) = (256 - <a_pm1, b_pm1>) / 2,

so a whole distance matrix is one float32 matmul. A sum of 256 terms of +/-1
is exact in float32, and stays exact under TF32 too; an int8 product would
wrap instead.
"""
from __future__ import annotations

import torch

HAMMING_DIST_THR_LOW = 50    # reference: match_base.h:13
MASK_DIST = 10_000           # sentinel for gated-out pairs (> any Hamming)


def unpack_bits_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 bit-views -> (..., 256) float32 in {-1, +1}, bits
    LSB-first per word."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).flatten(-2)


def hamming_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(..., A, 8) x (..., B, 8) int32 descriptors -> (..., A, B) int32."""
    a = unpack_bits_pm1(desc1)
    b = unpack_bits_pm1(desc2)
    dot = a @ b.transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)


def mutual_nn(dist: torch.Tensor, thr: int, ratio: float = 1.0):
    """Mutual-nearest selection over gated (..., A, B) distances.

    Per-row nearest neighbour (first index on ties), the mutual-consistency
    check and an absolute threshold; ``ratio < 1`` adds the Lowe test
    against the second-smallest distance of the row. Gated-out pairs must
    carry ``MASK_DIST``. Returns (nn_ab (..., A) int64, ok (..., A) bool)."""
    nn_ab = torch.argmin(dist, dim=-1)
    nn_ba = torch.argmin(dist, dim=-2)
    d_best = torch.amin(dist, dim=-1)
    rows = torch.arange(dist.shape[-2], device=dist.device)
    mutual = torch.gather(nn_ba, -1, nn_ab) == rows
    ok = mutual & (d_best <= thr)
    if ratio < 1.0:
        d_second = torch.topk(dist, 2, dim=-1, largest=False).values[..., 1]
        ok = ok & (d_best.to(torch.float32)
                   < ratio * d_second.to(torch.float32))
    return nn_ab, ok
