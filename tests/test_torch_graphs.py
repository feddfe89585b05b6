"""The port's one capture-and-replay mechanism (``ops/graphs.GraphCache``)
through its three programs: the BA buckets (``ops/ba.BA_GRAPHS``), the
interactive extraction (``ops/frontend.EXTRACT_GRAPHS``) and a shard's
chunk (``pipeline/device_vo._ChunkGraph.graphs``).

On the CPU, for each of the three: the first call runs op by op (the BA
and the extraction on the call's own tensors, the chunk through its
buffers), later calls through the same fixed buffers, every result equal
to the eager twin's; the counters and the timer's ``<prefix>.eager`` count
every run, nothing is captured or replayed, and ``clear`` drops it all.
With a toy program: unknown pool, lock or capture-mode values are refused,
a cover serves a first call from a held entry and is counted apart,
``reset_counts`` keeps the entries, and ``hold`` takes a lock a device, an
entry's own or none.

The ``cuda`` tests import no JAX and run on the card:

    python -m pytest tests/test_torch_graphs.py --noconftest -m cuda

For each of the three: call 0 eager, call 1 captured and replayed, calls 2
and 3 replayed, each bit-equal to the eager twin; the launches of the
hand-written kernels that ran counted once each (a capture's recorded
launches taken back out, added again per replay), the timer's spans and
the capture, replay events for every replay, a pool of its own, and
``clear``.
"""
import threading

import pytest
import torch

from slam_tpu_torch.kernels import launches
from slam_tpu_torch.ops import ba
from slam_tpu_torch.ops import frontend as F
from slam_tpu_torch.ops.graphs import GraphCache
from slam_tpu_torch.utils import timer

torch.set_num_threads(1)
KINDS = ("ba", "extract", "chunk")
CALLS = 4


class _BA:
    """Two-stage local-BA solves of one bucket (K 16, M 256, O 1024)."""

    def __init__(self, device):
        from test_torch_ba_graph import _on, _problem, _stages

        self.cache = ba.BA_GRAPHS
        self.args = [_on(_stages(_problem(s)), device) for s in range(CALLS)]
        self.recorded = {}

    def call(self, i):
        return ba.solve_ba_two_stage(*self.args[i], 2, 0)

    def twin(self, i):
        return ba.solve_ba_two_stage_eager(*self.args[i], 2, 0)

    def first_input(self, i):
        return self.args[i][0].poses

    def buffers(self, e):
        return e.inputs

    def equal(self, got, want, what):
        from test_torch_ba_graph import _equal

        _equal(got, want, what)

    def ran(self, i):
        return {}


class _Extract:
    """One 320x240 extractor, its tracked points changing from frame to
    frame; its words (K1) are enqueued behind the extraction, outside the
    graph."""

    def __init__(self, device):
        import test_torch_extract_graph as X

        self.X = X
        self.cache = F.EXTRACT_GRAPHS
        self.device = device
        self.ex = F.OrbExtractor(X._settings(), X.W, X.H,
                                 max_tracked=16, device=device)
        self.frames = X._frames(CALLS)
        self.recorded = {"detect.launch": 1, "orb.launch": 1}

    def call(self, i):
        return self.ex.detect_and_extract(
            self.frames[i], *self.X._tracked(i, self.ex.max_tracked))

    def twin(self, i):
        xy, _ = self.X._tracked(i, self.ex.max_tracked)
        return self.X._direct(self.ex, self.frames[i], xy, self.device)

    def first_input(self, i):
        return torch.from_numpy(self.frames[i])

    def buffers(self, e):
        return e.inputs

    def equal(self, got, want, what):
        self.X._assert_equal(got, want, what)

    def ran(self, i):
        # the capturing call runs the extraction once on the side stream
        return {"detect.launch": 2 if i == 1 else 1,
                "orb.launch": 2 if i == 1 else 1, "k1.launch": 1}


class _Chunk:
    """``test_torch_chunk_graph``'s two 160x120 sequences in chunks of 4,
    and the eager twin beside them."""

    def __init__(self, device):
        import test_torch_chunk_graph as C

        self.C = C
        scene = C.make_scene(CALLS)
        self.scene = scene
        self.vo, self.twin_vo = (C._vo(scene, device) for _ in range(2))
        self.cache = self.vo._chunks[0].graphs
        self.recorded = {"k1.launch": C.T, "detect.launch": C.T,
                         "orb.launch": C.T}

    def call(self, i):
        return self.vo.advance(*self.C._chunk(self.scene, i))

    def twin(self, i):
        return self.twin_vo._advance_eager(*self.C._chunk(self.scene, i))

    def first_input(self, i):
        return torch.from_numpy(self.C._chunk(self.scene, i)[0])

    def buffers(self, e):
        return [e.own.images, e.own.odom]

    def equal(self, got, want, what):
        self.C._assert_equal(got, want, what)

    def ran(self, i):
        return dict(self.recorded)


@pytest.fixture(autouse=True)
def _process_wide_caches():
    """The BA's and the extraction's caches empty before and after."""
    ba.BA_GRAPHS.clear()
    F.EXTRACT_GRAPHS.clear()
    yield
    ba.BA_GRAPHS.clear()
    F.EXTRACT_GRAPHS.clear()


def _make(kind, device):
    return {"ba": _BA, "extract": _Extract, "chunk": _Chunk}[kind](device)


@pytest.mark.parametrize("kind", KINDS)
def test_first_call_eager_then_fixed_buffers(kind):
    k = _make(kind, "cpu")
    stats = timer.enable_timing()
    try:
        got = [k.call(0)]
        (e,) = k.cache._entries.values()
        if kind == "chunk":                # the first chunk, eager
            assert e.own.warm              # through the shape's buffers
        else:
            assert e.inputs is None        # the first call's own tensors
        ptrs = None
        for i in range(1, CALLS):
            got.append(k.call(i))
            bufs = k.buffers(e)
            ptrs = ptrs or [b.data_ptr() for b in bufs]
            assert [b.data_ptr() for b in bufs] == ptrs
            assert torch.equal(bufs[0], k.first_input(i))
        assert k.cache.take_replay_events() is None
    finally:
        timer.disable_timing()
    for i, g in enumerate(got):
        k.equal(g, k.twin(i), f"call {i}")
    c = k.cache.counters()
    assert (c["buckets"], c["eager_runs"], c["captures"], c["replays"],
            c["covers"], c["pool_bytes"]) == (1, CALLS, 0, 0, 0, 0), c
    (b,) = k.cache.buckets()
    assert (b["calls"], b["graph"], b["launches"]) == (CALLS, False, {})
    p = k.cache.prefix
    assert stats.counts[f"{p}.eager"] == CALLS
    assert f"{p}.replay" not in stats.counts
    assert f"{p}.capture" not in stats.counts
    k.cache.clear()
    assert k.cache.counters()["eager_runs"] == 0 and k.cache.buckets() == []


def _toy(**facts):
    return GraphCache("toy", **dict(dict(pool="entry", lock="entry",
                                         capture_error_mode="thread_local",
                                         warm_up=True), **facts))


@pytest.mark.parametrize("facts", [dict(pool="device"), dict(lock="stream"),
                                   dict(capture_error_mode="relaxed")],
                         ids=["pool", "lock", "mode"])
def test_unknown_facts_are_refused(facts):
    with pytest.raises(ValueError):
        _toy(**facts)


def test_cover_serves_a_first_call_and_reset_counts_keeps_entries():
    """A first call served by a held entry counts as that entry's cover,
    not as an eager run; ``reset_counts`` zeroes calls and covers and
    keeps the entries and their buffers."""
    cpu = torch.device("cpu")
    g = _toy()
    stats = timer.enable_timing()
    try:
        big, first = g.entry(("big",), dict(n=8))
        assert first and g.eager(lambda t: t * 2, torch.ones(8))[0] == 2
        again, first = g.entry(("big",))
        assert again is big and not first
        g.copy_in(big, (torch.arange(8.0),), cpu)
        out = g.run(big, lambda: big.inputs[0] * 2, cpu)
        assert torch.equal(out, 2 * torch.arange(8.0)) and big.out is out
        _, first = g.entry(("small",), dict(n=4))
        assert first
        into = g.cover(lambda held: next(
            (h for h in held if h.inputs is not None), None))
        assert into is big
        big.inputs[0][:4].copy_(torch.full((4,), 5.0))
        assert g.run(into, lambda: into.inputs[0][:4] + 1, cpu,
                     own=False).tolist() == [6.0] * 4
        assert g.cover(lambda held: None) is None
    finally:
        timer.disable_timing()
    c = g.counters()
    assert (c["buckets"], c["eager_runs"], c["covers"], c["replays"]) == \
        (2, 2, 1, 0), c
    assert [(b["n"], b["calls"], b["covers"]) for b in g.buckets()] == \
        [(8, 2, 1), (4, 1, 0)]
    assert (stats.counts["toy.eager"], stats.counts["toy.cover"]) == (2, 1)
    g.reset_counts()
    c = g.counters()
    assert (c["buckets"], c["eager_runs"], c["covers"]) == (2, 0, 0), c
    assert [(b["calls"], b["covers"]) for b in g.buckets()] == [(0, 0)] * 2
    assert big.inputs is not None


@pytest.mark.parametrize("lock", ["device", "entry", None])
def test_hold_takes_the_lock_of_its_scope(lock):
    """While one entry is held, another entry of the same device waits for
    it where the lock is the device's, and goes on where it is the entry's
    own or there is none; the same entry always waits, but for none."""
    cpu = torch.device("cpu")
    g = _toy(lock=lock)
    a, _ = g.entry(("a",))
    b, _ = g.entry(("b",))

    def entered_while_held(e):
        done = threading.Event()

        def enter():
            with g.hold(e, cpu):
                done.set()

        t = threading.Thread(target=enter)
        with g.hold(a, cpu):
            t.start()
            entered = done.wait(timeout=0.5)
        t.join(timeout=10)
        assert not t.is_alive() and done.is_set()
        return entered

    assert entered_while_held(b) == (lock != "device")
    assert entered_while_held(a) == (lock is None)


# ---------------------------------------------------------------------------
# on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_capture_then_replays_on_card(kind):
    _need_card()
    k = _make(kind, "cuda")
    stats = timer.enable_timing()
    try:
        got = []
        for i in range(CALLS):
            before = {c.name: c.total for c in launches.COUNTERS}
            got.append(k.call(i))
            torch.cuda.synchronize()
            ran = {c.name: c.total - before[c.name] for c in launches.COUNTERS
                   if c.total != before[c.name]}
            assert ran == k.ran(i), (i, ran)
            assert (k.cache.take_replay_events() is not None) == (i > 0), i
    finally:
        timer.disable_timing()
    for i, g in enumerate(got):
        k.equal(g, k.twin(i), f"call {i}")
    (b,) = k.cache.buckets()
    assert b["graph"] and b["launches"] == k.recorded, b
    assert b["capture_seconds"] > 0
    c = k.cache.counters()
    assert (c["buckets"], c["eager_runs"], c["captures"], c["replays"]) == \
        (1, 1, 1, CALLS - 1), c
    assert c["pool_bytes"] > 0
    p = k.cache.prefix
    assert (stats.counts[f"{p}.eager"], stats.counts[f"{p}.capture"],
            stats.counts[f"{p}.replay"]) == (1, 1, CALLS - 1)
    k.cache.clear()
    c = k.cache.counters()
    assert (c["buckets"], c["pool_bytes"]) == (0, 0), c
