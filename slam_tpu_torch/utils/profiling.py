"""Device-side tracing hooks (``torch.profiler``; port of
slam_tpu/utils/profiling.py).

Complements the host section timers (`utils/timer.py`): capture a trace of
a block, viewable in Perfetto or ``chrome://tracing``, or annotate named
regions that appear in it.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda") -> Iterator[profile]:
    """Capture a ``torch.profiler`` trace around a block and export it as a
    Chrome trace to ``<log_dir>/trace.json``. On a CUDA device it records
    the host and the card's kernels; CPU activity alone only when the
    caller passes ``device="cpu"``.

    Usage::
        with device_trace("/tmp/slam_trace"):
            mapper.advance(mapper_input)
    """
    device = torch.device(device)
    if device.type == "cuda":
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    elif device.type == "cpu":
        activities = [ProfilerActivity.CPU]
    else:
        raise ValueError(f"no trace for device {device}")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str) -> record_function:
    """Named region annotation appearing in device traces."""
    return record_function(name)
