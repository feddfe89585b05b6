"""ctypes binding of ``csrc/orb_describe.cu``."""
from __future__ import annotations

import ctypes
import functools

import torch

from slam_tpu_torch.kernels.build import load_library

MAX_GROUPS = 17         # the tracked slots and 16 pyramid levels
# the plain version's patch round a clamped centre stays inside a level of
# 20 px or more on each side (wrapped round below 39 px)
MIN_SIDE = 20


class _GroupArg(ctypes.Structure):
    # csrc/orb_describe.cu: struct OrbGroupArg
    _fields_ = [("img", ctypes.c_void_p), ("blur", ctypes.c_void_p),
                ("xy", ctypes.c_void_p), ("h", ctypes.c_int),
                ("w", ctypes.c_int), ("n", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("orb_describe.cu").orb_describe_launch
    fn.argtypes = [ctypes.POINTER(_GroupArg), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(groups):
    """Raise ValueError on what the kernel cannot take, the device last;
    return (device, S, slots)."""
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"{len(groups)} groups: need 1..{MAX_GROUPS}")
    dev, S = groups[0][0].device, groups[0][0].shape[0]
    for i, (img, blur, xy) in enumerate(groups):
        for what, t in (("level", img), ("blurred level", blur)):
            if t.dtype != torch.float32 or t.dim() != 3 \
                    or not t.is_contiguous() or t.shape[0] != S:
                raise ValueError(
                    f"group {i}: the {what} must be a contiguous (S, H, W) "
                    f"float32 tensor with S = {S}, got {tuple(t.shape)} "
                    f"{t.dtype}")
        if blur.shape != img.shape:
            raise ValueError(f"group {i}: blurred level {tuple(blur.shape)} "
                             f"against level {tuple(img.shape)}")
        if min(img.shape[1:]) < MIN_SIDE:
            raise ValueError(f"group {i}: a {img.shape[2]} x {img.shape[1]} "
                             f"level; the kernel needs {MIN_SIDE} px or more "
                             f"on either side")
        if xy.dtype != torch.float32 or xy.dim() != 3 or xy.shape[0] != S \
                or xy.shape[2] != 2 or not xy.is_contiguous():
            raise ValueError(f"group {i}: keypoints must be a contiguous "
                             f"(S, N, 2) float32 tensor with S = {S}, got "
                             f"{tuple(xy.shape)} {xy.dtype}")
    for i, group in enumerate(groups):
        for t in group:
            if not t.is_cuda or t.device != dev:
                raise ValueError(f"group {i}: every tensor on one CUDA "
                                 f"device, got {t.device} beside {dev}")
    return dev, S, sum(xy.shape[1] for _, _, xy in groups)


def launch(groups):
    """Groups of (level, blurred level, keypoints): (S, H_g, W_g) float32
    CUDA images and (S, N_g, 2) float32 (x, y) ->
    (angles (S, N) float32 degrees, descriptors (S, N, 8) int32, number of
    kernel launches: 1, or 0 when there is no keypoint), N the groups' N_g
    summed, slots in group order, on the current stream. Checks what the
    kernel cannot take."""
    dev, S, slots = _check(groups)
    angles = torch.empty(S, slots, dtype=torch.float32, device=dev)
    desc = torch.empty(S, slots, 8, dtype=torch.int32, device=dev)
    if S * slots == 0:
        return angles, desc, 0
    args = (_GroupArg * len(groups))(*(
        _GroupArg(img.data_ptr(), blur.data_ptr(), xy.data_ptr(),
                  img.shape[1], img.shape[2], xy.shape[1])
        for img, blur, xy in groups))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(args, len(groups), S, angles.data_ptr(),
                       desc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"orb_describe kernel launch failed: "
                           f"cudaError {err}")
    return angles, desc, 1
