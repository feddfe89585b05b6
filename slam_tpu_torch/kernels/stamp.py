"""ctypes binding of ``csrc/stamp.cu``."""
from __future__ import annotations

import ctypes
import functools

import torch

from slam_tpu_torch.kernels.build import load_library


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("stamp.cu").stamp_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(slots: torch.Tensor, slot: int) -> None:
    """Write the card's ``%globaltimer`` (ns) into ``slots[slot]`` from one
    thread on the current stream. ``slots``: a contiguous int64 CUDA
    tensor."""
    if not slots.is_cuda or slots.dtype != torch.int64 or slots.dim() != 1 \
            or not slots.is_contiguous():
        raise ValueError(f"slots: need a contiguous 1-d int64 CUDA tensor, "
                         f"got {tuple(slots.shape)} {slots.dtype} "
                         f"{slots.device}")
    if not 0 <= slot < slots.shape[0]:
        raise ValueError(f"slot {slot} outside 0..{slots.shape[0] - 1}")
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(slots.data_ptr(), slot, stream)
    if err != 0:
        raise RuntimeError(f"stamp kernel launch failed: cudaError {err}")
