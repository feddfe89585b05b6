"""PyTorch + CUDA port of slam_tpu's device-resident serving path: the
batched VO backend and ``DeviceSlam``, its host loop-closure consumer.

The JAX package ``slam_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``pipeline/``) with torch tensors and an explicit leading
batch dimension where JAX used ``vmap``. Hand-written CUDA kernels live in
``csrc/`` and are built at first use by ``kernels/``.

This package imports nothing of JAX and nothing of ``slam_tpu``: it keeps
its own copies of what it needs from the JAX package's JAX-free modules
(``params``, ``geometry/camera``, ``geometry/se3``, ``ops/orb_pattern`` and
the trained vocabulary ``data/vocab_65536.npz``). Its entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
from slam_tpu_torch.pipeline.device_slam import DeviceSlam, DeviceSlamParams

__all__ = ["DeviceSlam", "DeviceSlamParams"]
