"""PyTorch + CUDA port of slam_tpu's device-resident VO serving path.

The JAX package ``slam_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``pipeline/``) with torch tensors and an explicit leading
batch dimension where JAX used ``vmap``. Hand-written CUDA kernels live in
``csrc/`` and are built at first use by ``kernels/``.

This package never imports JAX. From ``slam_tpu`` it uses only the modules
that are JAX-free: ``params``, ``ids``, ``geometry/*`` and
``ops/orb_pattern``.
"""
