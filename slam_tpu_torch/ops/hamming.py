"""Hamming distance between 256-bit ORB descriptors as a matmul (port of
slam_tpu/ops/hamming.py).

Descriptors travel as (..., 8) int32 tensors holding the bit pattern of the
reference's uint32 words (torch cannot right-shift uint32 on the CPU). With
the bits unpacked to +/-1,

    hamming(a, b) = (256 - <a_pm1, b_pm1>) / 2,

so a whole distance matrix is one float32 matmul. A sum of 256 terms of +/-1
is exact in float32, and stays exact under TF32 too; an int8 product would
wrap instead.

``hamming_matrix_host`` is the NumPy popcount-table matrix that the host
closure stack (``pipeline/device_slam.py``) runs on uint32 descriptors;
``hamming_distance`` the NumPy distance of descriptor pairs, and
``hamming_matrix_popcount`` the XOR-and-popcount reference of
``hamming_matrix``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

HAMMING_DIST_THR_LOW = 50    # reference: match_base.h:13
HAMMING_DIST_THR_HIGH = 100  # reference: match_base.h:14
MAX_HAMMING_DIST = 256       # reference: match_base.h:15
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


def hamming_matrix_popcount(desc1: torch.Tensor, desc2: torch.Tensor
                            ) -> torch.Tensor:
    """Reference path of :func:`hamming_matrix`, with the same results: XOR
    and a population count (a SWAR bit count in int64, as torch has no
    popcount). (..., A, 8) x (..., B, 8) int32 -> (..., A, B) int32."""
    x = (desc1[..., :, None, :] ^ desc2[..., None, :, :]).to(torch.int64)
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return torch.sum(x, dim=-1).to(torch.int32)


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


def hamming_distance(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Host-side Hamming distance of uint32 descriptors (..., 8), elementwise
    over the leading dimensions (NumPy popcount)."""
    d1 = np.asarray(d1, dtype=np.uint32)
    d2 = np.asarray(d2, dtype=np.uint32)
    x = (d1 ^ d2).view(np.uint8)
    return np.unpackbits(x, axis=-1).sum(axis=-1, dtype=np.int32)


@functools.lru_cache(maxsize=1)
def _popcount_table() -> np.ndarray:
    return np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                         axis=1).sum(1).astype(np.int32)


def hamming_matrix_host(desc1: np.ndarray, desc2: np.ndarray) -> np.ndarray:
    """Host NumPy (N, 8) x (M, 8) uint32 descriptors -> (N, M) int32."""
    a = np.ascontiguousarray(desc1, np.uint32).view(np.uint8).reshape(
        len(desc1), 32)
    b = np.ascontiguousarray(desc2, np.uint32).view(np.uint8).reshape(
        len(desc2), 32)
    t = _popcount_table()
    out = np.zeros((len(a), len(b)), dtype=np.int32)
    for k in range(32):
        out += t[(a[:, None, k] ^ b[None, :, k])]
    return out
