"""PyTorch + CUDA port of slam_tpu: the device-resident serving path (the
batched VO backend and ``DeviceSlam``, its host loop-closure consumer) and
the interactive session API (``pipeline.slam_api.Slam`` over
``pipeline.mapper.Mapper``: ORB extraction, local and global BA, Sim3 loop
closure).

The JAX package ``slam_tpu`` stays the reference; this package mirrors its
layout (``ids``, ``map/``, ``native/``, ``ops/``, ``pipeline/``, ``utils/``)
with torch tensors and an explicit leading batch dimension where JAX used
``vmap``. Hand-written CUDA kernels live in ``csrc/`` and are built at
first use by ``kernels/``.

This package imports nothing of JAX and nothing of ``slam_tpu``: it keeps
its own copies of what it needs from the JAX package's JAX-free modules
(the host map layer, the native host ops, ``params``, ``geometry``, the
ORB pattern and the trained vocabulary ``data/vocab_65536.npz``). Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
from slam_tpu_torch.pipeline.device_slam import DeviceSlam, DeviceSlamParams

__all__ = ["DeviceSlam", "DeviceSlamParams"]
