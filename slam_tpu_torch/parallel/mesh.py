"""Device-mesh helpers for multi-device scaling (port of
slam_tpu/parallel/mesh.py).

Multi-device operation is an optional batch axis: embarrassingly parallel
work (frames of different sequences) is split over a mesh of devices. There
is no cross-device map state: the map lives on the host, devices hold dense
batches, and sequences are independent, so no collectives are needed.

Axes:
  - ``data``: batch of frames / sequences, split over the devices;
  - ``hyp``: the RANSAC hypothesis axis of the JAX package's mesh. The port
    keeps it in the mesh's shape and does not split a hypothesis bank over
    it (a split bank would need a cross-device argmax, and one pair's bank
    is one batched solve): each data shard runs on the first device of its
    row.

A mesh is a NumPy array of ``torch.device`` with axis names. A list of
devices may name the same device more than once; that is how one card, or
the CPU, exercises the split and the merge.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh(NamedTuple):
    devices: np.ndarray              # object array of torch.device
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """Axis name -> size, as the JAX package's ``Mesh.shape``."""
        return OrderedDict(zip(self.axis_names, self.devices.shape))


class Sharding(NamedTuple):
    """Placement of a tensor whose leading dimension is split over ``axis``
    (``None``: the whole tensor on every device of the mesh)."""
    mesh: Mesh
    axis: Optional[str]

    @property
    def devices(self) -> List[torch.device]:
        """The device of each part, in order along the leading dimension."""
        if self.axis is None:
            return list(self.mesh.devices.reshape(-1))
        k = self.mesh.axis_names.index(self.axis)
        rows = np.moveaxis(self.mesh.devices, k, 0)
        return list(rows.reshape(rows.shape[0], -1)[:, 0])


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh over the first ``n_devices`` of ``devices`` (default:
    every CUDA card).

    With two axis names and no explicit shape, devices are split as evenly
    as possible between the axes (e.g. 8 -> (4, 2)). Asking for more CUDA
    devices than exist raises: nothing falls back to the CPU. A caller who
    wants CPU devices passes them, e.g. ``devices=[torch.device("cpu")] *
    8``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 0 < n_devices <= len(devices):
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}: "
                           f"{devices}")
    devices = devices[:n_devices]
    if shape is None:
        if len(axis_names) == 1:
            shape = (n_devices,)
        elif len(axis_names) == 2:
            hyp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
            shape = (n_devices // hyp, hyp)
        else:
            raise ValueError("give an explicit shape for >2 axes")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(axis_names))


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Sharding for tensors whose leading dim is the batch axis."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh, x, axis: str = "data") -> List[torch.Tensor]:
    """Split a host array or tensor along its leading dimension into one
    part per device of ``axis``, each on its device."""
    parts = batch_sharding(mesh, axis).devices
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if x.shape[0] % len(parts):
        raise ValueError(f"leading dimension {x.shape[0]} not divisible by "
                         f"mesh axis '{axis}'={len(parts)}")
    return [c.to(d) for c, d in zip(torch.chunk(x, len(parts)), parts)]
