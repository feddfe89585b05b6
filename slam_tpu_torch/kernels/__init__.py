"""Build and bind the hand-written CUDA kernels of ``slam_tpu_torch/csrc``.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Nothing is built at import: the first
launch builds, into ``build/slam_tpu_torch/`` beside the package, under a
file name keyed by the hash of the source and the flags.
"""
