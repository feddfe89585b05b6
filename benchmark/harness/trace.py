"""What a traced run records: host spans from the benchmark's own wrappers
around calls into each layer, the program's ``utils/timer`` sections, and
a ``torch.profiler`` trace of a short sub-window of device work.

Host spans and timer sections cover the whole measured window; the device
trace covers a fixed stretch of it (some chunks or frames), so that the
trace stays small enough to read inside a run's time limit.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

K1_KERNEL = "hamming_argmin_kernel"
# the profiler's own host event while it copies its buffers out: the card
# idles behind it for the profiler's sake, not the program's
PROFILER_FLUSH = "Buffer Flush"


class Spans:
    """Host durations by name, from wrappers the benchmark puts around
    calls into the program. Off (``enabled = False``) in untraced runs."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        return wrapped

    def reset(self):
        self.seconds.clear()


def union_busy(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def idle_within(busy, spans) -> float:
    """Length of the union of ``spans`` in which no ``busy`` interval
    runs."""
    return union_busy(list(busy) + list(spans)) - union_busy(busy)


class DeviceTrace:
    """``torch.profiler`` over a sub-window opened by ``start`` and closed
    by ``stop``; ``read`` reduces it to device busy time, time by kernel
    name, K1's calls and the longest idle gaps by the host span that was
    open when each began."""

    def __init__(self, device, k1=None, span_names=()):
        self.device = torch.device(device)
        self.span_names = set(span_names)
        self.prof = None
        self.t0 = self.t1 = None
        self.k1 = k1              # K1Shapes: the launches seen meanwhile
        self.k1_span = (0, 0)

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.k1_span = (len(self.k1.calls) if self.k1 else 0, None)

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.k1_span = (self.k1_span[0],
                        len(self.k1.calls) if self.k1 else 0)

    def read(self) -> dict:
        dev, host = [], []
        for e in self.prof.events():
            s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
            if getattr(e, "is_user_annotation", False) \
                    or e.name in self.span_names:
                # the benchmark's own spans, mirrored on the device
                # timeline: no device work of their own
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    host.append((s, t, e.name))
                continue
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((s, t, e.name))
            elif e.name and not e.name.startswith(("aten::", "cuda")):
                host.append((s, t, e.name))
        busy = union_busy((s, e) for s, e, _ in dev)
        flush_idle = idle_within([(s, e) for s, e, _ in dev],
                                 [(s, e) for s, e, n in host
                                  if n == PROFILER_FLUSH])
        by_name = defaultdict(float)
        for s, e, n in dev:
            by_name[n] += e - s
        k1 = sorted((s, e - s) for s, e, n in dev if K1_KERNEL in n)
        gaps = []
        spans = sorted((s, e) for s, e, _ in dev)
        end = spans[0][1] if spans else None
        for s, e in spans[1:]:
            if s > end:
                gaps.append((end, s - end))
            end = max(end, e)
        labelled = []
        for g0, length in sorted(gaps, key=lambda g: -g[1])[:10]:
            open_ = [h for h in host if h[0] <= g0 < h[1]]
            name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ \
                else "host"
            labelled.append([name, length])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return dict(busy_s=busy, traced_s=self.t1 - self.t0,
                    flush_idle_s=flush_idle,
                    device_ops=[list(x) for x in top],
                    idle_gaps=labelled, k1_seconds=[d for _, d in k1],
                    k1_shapes_traced=(self.k1.calls[slice(*self.k1_span)]
                                      if self.k1 else []))


class K1Shapes:
    """(N, V) of every K1 launch the program makes outside a replayed graph
    (the kernel's entry, ``slam_tpu_torch.kernels.hamming_argmin.launch``);
    a graph's K1 calls are seen once, at capture."""

    def __init__(self):
        self.calls = []

    def install(self):
        from slam_tpu_torch.kernels import hamming_argmin as k

        launch = k.launch

        def counted(desc, codebook):
            self.calls.append((int(desc.shape[0]), int(codebook.shape[0])))
            return launch(desc, codebook)

        k.launch = counted
        return self
