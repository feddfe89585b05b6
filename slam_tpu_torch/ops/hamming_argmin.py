"""Nearest codeword of each descriptor: min Hamming distance + first argmin.

On CUDA tensors this runs the hand-written kernel ``csrc/hamming_argmin.cu``,
which replaces the Pallas TPU kernel
``slam_tpu/ops/pallas_kernels.py:_hamming_argmin_kernel``: one launch that
takes 1-bit and-popcount products on the tensor cores, splits the codebook
over a thread-block cluster and keeps the (N, V) distance matrix out of
device memory. The plain version below materialises it. On CPU tensors the
plain version runs.

The main path calls this for the in-scan loop retrieval's quantisation
(``pipeline/device_vo.py``, the counterpart of slam_tpu's
``words = argmin(hamming_matrix(desc, loop_cb))``), one launch per frame
for all S sequences.
"""
from __future__ import annotations

import torch

from slam_tpu_torch.ops.hamming import hamming_matrix


def hamming_argmin_plain(desc: torch.Tensor, codebook: torch.Tensor):
    """(N, 8) x (V, 8) int32 -> (dist (N,), idx (N,)) int32, via the full
    distance matrix; ties go to the first index."""
    d = hamming_matrix(desc, codebook)
    return (torch.amin(d, dim=1),
            torch.argmin(d, dim=1).to(torch.int32))


def hamming_argmin(desc: torch.Tensor, codebook: torch.Tensor):
    """(N, 8) x (V, 8) int32 -> (dist (N,), idx (N,)) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    (counted in ``hamming_argmin.launches``; N = 0 launches nothing) or
    raise."""
    if desc.device.type == "cpu" and codebook.device.type == "cpu":
        return hamming_argmin_plain(desc, codebook)
    from slam_tpu_torch.kernels import hamming_argmin as kernel

    dist, idx, launched = kernel.launch(desc, codebook)
    hamming_argmin.launches += launched
    return dist, idx


hamming_argmin.launches = 0
