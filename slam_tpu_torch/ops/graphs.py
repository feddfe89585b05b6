"""One capture-and-replay mechanism for the port's CUDA-graph programs.

A :class:`GraphCache` holds one program per key its caller builds, as the
JAX package's jit cache holds one compiled program per static arguments and
shapes. The caller looks an :class:`Entry` up (:meth:`GraphCache.entry`),
runs a first call op by op (:meth:`GraphCache.eager`), copies later calls'
inputs into the entry's fixed buffers (:meth:`GraphCache.copy_in`) and runs
the entry there (:meth:`GraphCache.run`): on a card its CUDA graph, captured
at the first such run and replayed on the caller's current stream; on the
CPU the same function op by op on the same buffers. A failed capture or
replay raises; nothing carries on eagerly.

Three instances exist, each with its facts fixed at construction:

=================  ===================  ====================  ==============
fact               ``ops/ba``           ``ops/frontend``      ``device_vo``
                   ``BA_GRAPHS``        ``EXTRACT_GRAPHS``    a shard's chunk
=================  ===================  ====================  ==============
timer prefix       ``ba``               ``extract``           ``vo``
pool               a device and stream  an entry              the shard
capture mode       ``thread_local``     ``thread_local``      ``global``
before a capture   one run on the       one run on the side   nothing: the
                   side stream          stream, TF32 off,     first chunk ran
                                        the band matrices     eagerly, and the
                                        held by the entry     state is updated
                                                              in place
lock               a device's, from     the entry's, while    none (one
                   the input copy to    the caller enqueues   caller a shard)
                   the outputs' clone   what reads the
                                        outputs
=================  ===================  ====================  ==============

A replay rewrites the outputs of the graph it replays, and everything else
allocated in the graph's pool while it was captured, such as the copies
``benchmark/harness/fleet.ChunkRecords`` takes inside the chunk. No two
instances therefore share a pool, and each caller reads or copies its
outputs before the next call of the entry can replay it: under the lock
where there is one.

While ``utils/timer`` is on, each eager run and replay is the span
``<prefix>.eager`` / ``<prefix>.replay``, each cover the counter
``<prefix>.cover``, each capture ``<prefix>.capture`` with its seconds (its
warm-up run included), and CUDA timing events around each replay wait for
whoever collects the result (:meth:`GraphCache.take_replay_events`). A
capture takes the hand-written kernels' launches it records back out of
``kernels/launches``, and each replay adds them again.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional

import torch

from slam_tpu_torch.kernels import launches
from slam_tpu_torch.utils import timer

POOLS = ("stream", "entry", "cache")
LOCKS = ("device", "entry", None)
MODES = ("thread_local", "global")


def where(device) -> tuple:
    """(``device`` with its index, whether it is a card, the id of its
    current stream; 0 on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device, False, 0
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, True, torch.cuda.current_stream(device).cuda_stream


class Entry:
    """One key's program: its sizes for the listing (``dims``), calls,
    first calls of other keys it served, fixed input buffers, the graph
    with the outputs it writes (on the CPU, the last eager run's), the
    kernel launches its capture recorded, its capture's seconds, what the
    cache's ``before_capture`` returned (held for the graph's life), and
    ``own``, whatever the caller keeps beside it."""

    def __init__(self, key: tuple, dims: dict):
        self.key = key
        self.dims = dims
        self.calls = self.covers = 0
        self.inputs = None
        self.graph = None
        self.out = None
        self.launches: Dict[str, int] = {}
        self.capture_seconds: Optional[float] = None
        self.lock = threading.Lock()
        self.held = None
        self.own = None


class GraphCache:
    """Entries keyed by the caller, each one program (see the module).

    ``pool``: ``"stream"`` one memory pool per device and stream, shared
    by the entries captured there; ``"entry"`` one per entry; ``"cache"``
    one for the whole cache. ``lock``: what :meth:`hold` takes, a lock per
    ``"device"``, the ``"entry"``'s own, or none. ``warm_up``: run the
    function once on the side stream before capturing it (its library
    handles and workspaces). ``before_capture(key)``: called first in a
    capture; the entry holds what it returns."""

    def __init__(self, prefix: str, *, pool: str, lock: Optional[str],
                 capture_error_mode: str, warm_up: bool,
                 before_capture: Optional[Callable[[tuple], object]] = None):
        if pool not in POOLS or lock not in LOCKS \
                or capture_error_mode not in MODES:
            raise ValueError(f"pool {pool!r}, lock {lock!r}, capture mode "
                             f"{capture_error_mode!r}")
        self.prefix = prefix
        self._pool = pool
        self._lock_scope = lock
        self._mode = capture_error_mode
        self._warm_up = warm_up
        self._before_capture = before_capture
        self._entries: Dict[tuple, Entry] = {}
        self._lock = threading.Lock()         # the dicts and the counters
        self._local = threading.local()       # this thread's last replay
        self._device_locks: Dict[torch.device, threading.Lock] = {}
        self._pools: Dict[object, tuple] = {}
        # device -> (side stream, the lock of the captures that share it)
        self._side: Dict[torch.device, tuple] = {}
        self.clear()

    def reset_counts(self) -> None:
        """Zero the counters and every entry's calls and covers; graphs
        stay."""
        with self._lock:
            self.eager_runs = self.captures = self.replays = self.covers = 0
            self.capture_seconds = []
            for e in self._entries.values():
                e.calls = e.covers = 0

    def clear(self) -> None:
        """Drop every entry, graph and pool, and zero the counters."""
        with self._lock:
            self._entries.clear()
            self._pools.clear()
        self.reset_counts()

    def entry(self, key: tuple, dims: Optional[dict] = None) -> tuple:
        """(the entry of ``key``, made with ``dims`` if it is new; whether
        it is new), its calls counted. Forgets this thread's replay events:
        a call that does not replay leaves none."""
        self._local.replay = None
        with self._lock:
            e = self._entries.get(key)
            first = e is None
            if first:
                e = self._entries[key] = Entry(key, dims or {})
            e.calls += 1
        return e, first

    def cover(self, pick: Callable[[list], Optional[Entry]]
              ) -> Optional[Entry]:
        """The held entry that ``pick`` chooses, from all in order of first
        sighting, to serve a first call, counted as a cover (then run it
        with ``own=False``); None if it chooses none."""
        with self._lock:
            e = pick(list(self._entries.values()))
            if e is not None:
                e.covers += 1
                self.covers += 1
                timer.count(f"{self.prefix}.cover")
        return e

    @contextlib.contextmanager
    def hold(self, e: Entry, device: torch.device):
        """The lock of ``e`` (per the cache's ``lock``) with ``device`` the
        current card."""
        if self._lock_scope == "device":
            with self._lock:
                lock = self._device_locks.setdefault(device, threading.Lock())
        elif self._lock_scope == "entry":
            lock = e.lock
        else:
            lock = contextlib.nullcontext()
        with lock, (torch.cuda.device(device) if device.type == "cuda"
                    else contextlib.nullcontext()):
            yield

    def copy_in(self, e: Entry, tensors, device: torch.device) -> None:
        """Copy ``tensors`` (host tensors pinned, or on ``device``) into the
        entry's fixed input buffers, made like them on ``device`` at its
        first copy, without waiting for the card."""
        if e.inputs is None:
            e.inputs = [torch.empty(t.shape, dtype=t.dtype, device=device)
                        for t in tensors]
        for d, s in zip(e.inputs, tensors):
            d.copy_(s, non_blocking=True)

    def eager(self, fn, *args):
        """``fn(*args)`` op by op, counted as an eager run."""
        with self._lock:
            self.eager_runs += 1
        with timer.section(f"{self.prefix}.eager"):
            return fn(*args)

    def run(self, e: Entry, fn: Callable[[], object], device: torch.device,
            own: bool = True):
        """The entry's program, ``fn()`` over its fixed buffers: on a card
        its graph (captured first if it has none) replayed on the current
        stream, on the CPU ``fn()`` op by op. Returns the outputs, which
        the entry's next run overwrites. ``own`` False: the entry serves a
        call of another key, counted by :meth:`cover` alone."""
        if device.type != "cuda":
            e.out = self.eager(fn) if own else fn()
            return e.out
        if e.graph is None:
            self._capture(e, fn, device)
        with (timer.section(f"{self.prefix}.replay") if own
              else contextlib.nullcontext()):
            if timer.TIME_STATS is None:
                e.graph.replay()
            else:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                e.graph.replay()
                end.record()
                self._local.replay = (start, end)
        launches.replay(e.launches)
        if own:
            with self._lock:
                self.replays += 1
        return e.out

    def _capture(self, e: Entry, fn, device: torch.device) -> None:
        t0 = time.perf_counter()
        if self._before_capture is not None:
            e.held = self._before_capture(e.key)
        caller = torch.cuda.current_stream(device)
        pool_key = {"stream": (device, caller.cuda_stream), "entry": e.key,
                    "cache": None}[self._pool]
        with self._lock:
            if device not in self._side:
                self._side[device] = (torch.cuda.Stream(device),
                                      threading.Lock())
            side, side_lock = self._side[device]
            if pool_key not in self._pools:
                self._pools[pool_key] = torch.cuda.graph_pool_handle()
            pool = self._pools[pool_key]
        with side_lock:
            if self._warm_up:
                side.wait_stream(caller)
                with torch.cuda.stream(side):
                    fn()
                caller.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with launches.capture() as e.launches, \
                    torch.cuda.graph(graph, pool=pool, stream=side,
                                     capture_error_mode=self._mode):
                e.out = fn()
        e.graph = graph
        e.capture_seconds = time.perf_counter() - t0
        with self._lock:
            self.captures += 1
            self.capture_seconds.append(e.capture_seconds)
        timer.add(f"{self.prefix}.capture", e.capture_seconds)

    def take_replay_events(self) -> Optional[tuple]:
        """(start, end) CUDA events around this thread's last replay, if
        timing was on for it and no one has taken them; then forgets
        them."""
        events = getattr(self._local, "replay", None)
        self._local.replay = None
        return events

    def buckets(self) -> list:
        """Each entry's ``dims``, calls, the first calls of other keys it
        served, whether it has a graph, the launches its capture recorded
        and its capture's seconds, in the order of first sighting."""
        with self._lock:
            return [dict(e.dims, calls=e.calls, covers=e.covers,
                         graph=e.graph is not None,
                         launches=dict(e.launches),
                         capture_seconds=e.capture_seconds)
                    for e in self._entries.values()]

    def pool_bytes(self) -> int:
        """Device bytes the pools hold (their segments in the allocator's
        snapshot)."""
        with self._lock:
            pools = {tuple(p) for p in self._pools.values()}
        if not pools:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) in pools)

    def counters(self) -> dict:
        """Buckets (entries) seen, eager runs, captures, replays (of an
        entry's own calls), covers, seconds a capture and the pools'
        bytes."""
        with self._lock:
            out = dict(buckets=len(self._entries), eager_runs=self.eager_runs,
                       captures=self.captures, replays=self.replays,
                       covers=self.covers,
                       capture_seconds=list(self.capture_seconds))
        out["pool_bytes"] = self.pool_bytes()
        return out
