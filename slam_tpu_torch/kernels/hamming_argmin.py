"""ctypes binding of ``csrc/hamming_argmin.cu``."""
from __future__ import annotations

import ctypes
import functools

import torch

from slam_tpu_torch.kernels.build import load_library


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("hamming_argmin.cu").hamming_argmin_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(desc: torch.Tensor, codebook: torch.Tensor):
    """(N, 8) x (V, 8) int32 CUDA tensors -> (dist (N,), idx (N,) int32,
    number of kernel launches: 1, or 0 for N = 0), on the current stream.
    Checks what the kernel cannot take."""
    for name, t in (("desc", desc), ("codebook", codebook)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 2 \
                or t.shape[1] != 8 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous (n, 8) int32 CUDA "
                             f"tensor, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")
    if desc.device != codebook.device:
        raise ValueError(f"desc on {desc.device}, codebook on "
                         f"{codebook.device}")
    n, v = desc.shape[0], codebook.shape[0]
    if not 0 < v <= 65536:
        raise ValueError(f"codebook rows {v} outside 1..65536")
    dist, idx = torch.empty((2, n), dtype=torch.int32, device=desc.device)
    if n == 0:
        return dist, idx, 0
    with torch.cuda.device(desc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(desc.data_ptr(), codebook.data_ptr(), n, v,
                       dist.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hamming_argmin kernel launch failed: "
                           f"cudaError {err}")
    return dist, idx, 1
