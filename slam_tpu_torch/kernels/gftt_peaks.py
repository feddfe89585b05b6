"""ctypes binding of ``csrc/gftt_peaks.cu``."""
from __future__ import annotations

import ctypes
import functools

import torch

from slam_tpu_torch.kernels.build import load_library

MAX_LEVELS = 16


class _LevelArg(ctypes.Structure):
    # csrc/gftt_peaks.cu: struct GfttLevelArg
    _fields_ = [("img", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("md", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("gftt_peaks.cu").gftt_peaks_launch
    fn.argtypes = [ctypes.POINTER(_LevelArg), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def max_min_distance(device: torch.device) -> int:
    """The largest min distance whose tile and halo fit in the shared
    memory of one block on ``device``: 56 on an H100."""
    fn = load_library("gftt_peaks.cu").gftt_peaks_max_min_distance
    fn.argtypes = []
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        md = fn()
    if md < 1:
        raise RuntimeError(f"gftt_peaks: no shared memory limit read on "
                           f"{device}")
    return md


def launch(levels, min_dists, margin: int):
    """(S, H_l, W_l) float32 CUDA levels, their min distances (1 to
    :func:`max_min_distance`) ->
    (list of (S, H_l, W_l) float32 masked maps, views of one buffer;
    number of kernel launches: 1, or 0 for S = 0), on the current stream.
    Checks what the kernel cannot take."""
    if not 1 <= len(levels) <= MAX_LEVELS or len(min_dists) != len(levels):
        raise ValueError(f"{len(levels)} levels and {len(min_dists)} min "
                         f"distances: need 1..{MAX_LEVELS} of each")
    dev, S = levels[0].device, levels[0].shape[0]
    for i, t in enumerate(levels):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 \
                or not t.is_contiguous() or t.device != dev \
                or t.shape[0] != S or t.shape[1] < 1 or t.shape[2] < 1:
            raise ValueError(f"level {i}: need a contiguous (S, H, W) "
                             f"float32 tensor on {dev} with S = {S}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    if min(min_dists) < 1:
        raise ValueError(f"min distances {list(min_dists)}: need >= 1")
    if max(min_dists) > max_min_distance(dev):
        raise ValueError(f"min distance {max(min_dists)}: a tile's halo "
                         f"fits in one block's shared memory on {dev} up to "
                         f"{max_min_distance(dev)}")
    sizes = [t.shape[1] * t.shape[2] for t in levels]
    flat = torch.empty(S * sum(sizes), dtype=torch.float32, device=dev)
    maps, start = [], 0
    for t, n in zip(levels, sizes):
        maps.append(flat[start:start + S * n].view(t.shape))
        start += S * n
    if S == 0:
        return maps, 0
    args = (_LevelArg * len(levels))(*(
        _LevelArg(t.data_ptr(), o.data_ptr(), t.shape[1], t.shape[2], md)
        for t, o, md in zip(levels, maps, min_dists)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(args, len(levels), S, int(margin), stream)
    if err != 0:
        raise RuntimeError(f"gftt_peaks kernel launch failed: "
                           f"cudaError {err}")
    return maps, 1
