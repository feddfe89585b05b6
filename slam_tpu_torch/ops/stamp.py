"""Stage stamps: where each stage of a stream's work ends, on the clock of
the device that runs it.

``stamp(slots, slot)`` writes a timestamp (ns) into ``slots[slot]``, in
stream order: on a card the hand-written one-thread kernel
``csrc/stamp.cu`` reads ``%globaltimer`` when the work enqueued before it
has run; on the CPU, where ops run as they are issued, it takes
``time.perf_counter_ns``. It is an operator of its own
(``slam_tpu_torch::stamp``), so a CUDA graph captures it as one node and a
trace under fake tensors shows it. The serving path's chunk
(``pipeline/device_vo``) stamps the end of every stage of every frame
step, of every window BA and of the snapshot rows; ``durations`` turns a
chunk's stamps into seconds by stage.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch


def _stamp_cpu(slots: torch.Tensor, slot: int) -> None:
    slots[slot:slot + 1].fill_(time.perf_counter_ns())


def _stamp_cuda(slots: torch.Tensor, slot: int) -> None:
    from slam_tpu_torch.kernels import stamp as kernel

    kernel.launch(slots, slot)


def _stamp_meta(slots: torch.Tensor, slot: int) -> None:
    return None


# registered through ``torch.library.Library``: its first call imports
# nothing (``torch.library.custom_op``'s took seconds of imports)
_LIB = torch.library.Library("slam_tpu_torch", "DEF")
_LIB.define("stamp(Tensor(a!) slots, int slot) -> ()")
_LIB.impl("stamp", _stamp_cpu, "CPU")
_LIB.impl("stamp", _stamp_cuda, "CUDA")
_LIB.impl("stamp", _stamp_meta, "Meta")


def stamp(slots: torch.Tensor, slot: int) -> None:
    """``slots[slot]`` <- the time (ns) at which the stream reaches it."""
    torch.ops.slam_tpu_torch.stamp(slots, slot)


class Stamper:
    """Writes the next slot of ``slots`` at each call; ``slot`` is how many
    stamps it has written."""

    def __init__(self, slots: torch.Tensor):
        self.slots = slots
        self.slot = 0

    def __call__(self) -> None:
        stamp(self.slots, self.slot)
        self.slot += 1


def durations(stamps: np.ndarray, stages: Sequence[str]) -> Dict[str, float]:
    """Seconds by stage name: ``stages[i]`` is the work between stamps i
    and i + 1 (``len(stages) + 1`` stamps a row); rows (one a shard) are
    summed."""
    st = np.asarray(stamps, np.int64).reshape(-1, len(stages) + 1)
    gaps = np.diff(st, axis=1).sum(axis=0) * 1e-9
    out: Dict[str, float] = {}
    for name, s in zip(stages, gaps):
        out[name] = out.get(name, 0.0) + float(s)
    return out
