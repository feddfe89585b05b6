"""Full-f32 pin for the geometry path.

The JAX package runs its pose chain, triangulation and LM solves at
``default_matmul_precision("highest")`` (slam_tpu/pipeline/device_vo.py
``_geom_precision``, slam_tpu/ops/ba.py ``_lm_run``): reduced-precision
contractions were measured to wander the pose chain by 0.45 m. On an NVIDIA
card the reduced mode is TF32, which PyTorch enables by default for cuDNN
convolutions and can enable for matmuls. The pyramid's band matmuls would
also flip rint results under TF32. The main path's frame step
(``pipeline/device_vo.make_vo_step``) calls :func:`pin_full_f32` first.
"""
from __future__ import annotations

import torch


def pin_full_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN, and check that it stuck."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
