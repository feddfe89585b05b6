"""Nearest codeword of each descriptor: min Hamming distance + first argmin.

On CUDA tensors this runs the hand-written kernel ``csrc/hamming_argmin.cu``,
which replaces the Pallas TPU kernel
``slam_tpu/ops/pallas_kernels.py:_hamming_argmin_kernel``: one launch that
takes 1-bit and-popcount products on the tensor cores, splits the codebook
over a thread-block cluster and keeps the (N, V) distance matrix out of
device memory. The plain version below materialises it. On CPU tensors the
plain version runs.

The serving path calls this for the in-scan loop retrieval's quantisation
(``pipeline/device_vo.py``, the counterpart of slam_tpu's
``words = argmin(hamming_matrix(desc, loop_cb))``), one launch per frame
for all S sequences. The interactive path calls it at the 65,536-word
vocabulary: the fused BoW words of every ``ops/frontend.OrbExtractor``
extraction and ``ops/bow.quantize``'s device branch.
"""
from __future__ import annotations

import threading

import torch

from slam_tpu_torch.ops.hamming import hamming_matrix


# concurrent sessions (parallel/batch.py) launch from several threads; the
# launch counters add under this lock so that no launch goes uncounted
COUNT_LOCK = threading.Lock()
# codebook rows per distance matrix of the plain version: an (N, 65536)
# float32 matrix would take 224 MB at N = 856
_PLAIN_CHUNK = 8192


def hamming_argmin_plain(desc: torch.Tensor, codebook: torch.Tensor):
    """(N, 8) x (V, 8) int32 -> (dist (N,), idx (N,)) int32, via distance
    matrices of ``_PLAIN_CHUNK`` codebook rows at a time; ties go to the
    first index."""
    best_d = best_i = None
    for start in range(0, max(codebook.shape[0], 1), _PLAIN_CHUNK):
        d = hamming_matrix(desc, codebook[start:start + _PLAIN_CHUNK])
        dmin = torch.amin(d, dim=1)
        imin = torch.argmin(d, dim=1).to(torch.int32) + start
        if best_d is None:
            best_d, best_i = dmin, imin
        else:
            better = dmin < best_d               # strict: earlier chunk wins
            best_d = torch.where(better, dmin, best_d)
            best_i = torch.where(better, imin, best_i)
    return best_d, best_i


def hamming_argmin(desc: torch.Tensor, codebook: torch.Tensor):
    """(N, 8) x (V, 8) int32 -> (dist (N,), idx (N,)) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    (counted in ``hamming_argmin.launches``; N = 0 launches nothing) or
    raise."""
    if desc.device.type == "cpu" and codebook.device.type == "cpu":
        return hamming_argmin_plain(desc, codebook)
    from slam_tpu_torch.kernels import hamming_argmin as kernel

    dist, idx, launched = kernel.launch(desc, codebook)
    with COUNT_LOCK:
        hamming_argmin.launches += launched
    return dist, idx


hamming_argmin.launches = 0
