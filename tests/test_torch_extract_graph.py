"""The interactive extraction's one-program dispatch
(``ops/frontend.extraction`` over ``EXTRACT_GRAPHS``): every
``OrbExtractor`` of one geometry (device, stream, ``FrontendSpec``, slots)
shares one entry; its
first call runs ``extract`` on fresh tensors, its later calls copy the image
and the tracked points into the entry's fixed buffers and, on a card,
replay the entry's CUDA graph (on the CPU they run ``extract`` eagerly on
those buffers). K1's words stay one eager launch behind the extraction.

On the CPU, at 320x240 with the 65,536-word vocabulary: a sequence of
frames whose tracked points change (some frames have none) equals direct
``extract`` and ``hamming_argmin`` calls, collected at once or prefetched;
the key separates slot counts and image sizes and is shared by two
extractors of one geometry; prefetches of two geometries interleaved
collect what direct calls give. The counters and the timer's names, for
the three graph programs at once, are in ``tests/test_torch_graphs.py``.

The ``cuda`` tests import no JAX and run on the card:

    python -m pytest tests/test_torch_extract_graph.py --noconftest -m cuda

They hold the replays of the tracker's (1,128-slot) and the Mapper's
(1,256-slot) 752x480 extractors bit-equal to the eager path in all six
outputs over 24 rendered frames, with one K1 launch per extraction, and
capture while another thread replays a BA graph.
"""
import threading

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops import frontend as F
from slam_tpu_torch.ops.hamming_argmin import hamming_argmin
from slam_tpu_torch.params import Parameters, ParametersSlam, StaticSettings
from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                            render_frame)

torch.set_num_threads(1)
W, H = 320, 240
FIELDS = ("pts", "octave", "angle", "descriptors", "valid", "words")


def _frames(n, w=W, h=H, seed=31):
    world = make_world(n_frames=n, n_landmarks=500, seed=seed,
                       trajectory="loop", lap_frames=64,
                       camera=default_camera(w, h))
    patches = np.random.default_rng(seed).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    return [render_frame(world, patches, i, w, h) for i in range(n)]


def _settings(keypoints=300, vocab=65536):
    return StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=keypoints, bowVocabularySize=vocab)))


def _tracked(i, n):
    """Frame ``i``'s tracked points: none on every third frame, else a
    number and a placement that change from frame to frame."""
    if i % 3 == 0:
        return None, None
    rng = np.random.default_rng(i)
    k = min(n, 4 + 5 * i)
    xy = np.stack([rng.uniform(0, W, k), rng.uniform(0, H, k)], 1)
    return xy.astype(np.float32), np.arange(k) + 100 * i


def _direct(ex, frame, xy, device="cpu"):
    """``extract`` and ``hamming_argmin`` called directly on fresh tensors:
    the six outputs as NumPy."""
    t = ex.max_tracked
    txy = np.zeros((t, 2), np.float32)
    tvalid = np.zeros(t, bool)
    if xy is not None:
        txy[:len(xy)] = xy[:t]
        tvalid[:len(xy)] = True
    put = lambda a: torch.from_numpy(a).to(device)
    f = F.extract(put(np.ascontiguousarray(frame))[None], put(txy)[None],
                  put(tvalid)[None], ex._spec)
    desc = f.desc[0].contiguous()
    _, words = hamming_argmin(desc, ex._vocabulary())
    return dict(pts=f.pts[0], octave=f.octave[0], angle=f.angle[0],
                descriptors=desc, valid=f.valid[0], words=words)


def _assert_equal(got, want, what):
    for name in FIELDS:
        w = want[name].cpu().numpy()
        if name == "descriptors":
            w = w.view(np.uint32)
        np.testing.assert_array_equal(getattr(got, name), w,
                                      err_msg=f"{what}: {name}")


@pytest.fixture
def cache():
    F.EXTRACT_GRAPHS.clear()
    yield F.EXTRACT_GRAPHS
    F.EXTRACT_GRAPHS.clear()


@pytest.fixture(scope="module")
def frames():
    return _frames(6)


@pytest.mark.parametrize("collect", ["direct", "prefetched"])
def test_buffer_path_equals_direct_calls(cache, frames, collect):
    ex = F.OrbExtractor(_settings(), W, H, max_tracked=32, device="cpu")
    for i, frame in enumerate(frames):
        xy, ids = _tracked(i, ex.max_tracked)
        if collect == "direct":
            got = ex.detect_and_extract(frame, xy, ids)
        else:
            ex.prefetch(i, frame, xy, ids)
            got = ex.detect_and_extract(None, key=i)
        _assert_equal(got, _direct(ex, frame, xy), f"frame {i}")
        if xy is not None:
            np.testing.assert_array_equal(got.track_ids[:len(ids)], ids)
        assert got.valid.sum() > 100
    assert cache.buckets() == [dict(width=W, height=H, slots=ex.num_slots,
                                    calls=len(frames), covers=0, graph=False,
                                    launches={}, capture_seconds=None)]


def test_key_separates_slots_and_sizes_and_is_shared(cache):
    """The tracker's 1,128 slots, the Mapper's 1,256 and a second image
    size are three entries; a second extractor of the tracker's geometry
    shares the first's."""
    s = _settings(keypoints=1000, vocab=0)
    (room,) = _frames(1, 752, 480)
    (small,) = _frames(1)
    tracker = F.OrbExtractor(s, 752, 480, max_tracked=128, device="cpu")
    mapper = F.OrbExtractor(s, 752, 480, max_tracked=256, device="cpu")
    other = F.OrbExtractor(s, W, H, max_tracked=256, device="cpu")
    again = F.OrbExtractor(s, 752, 480, max_tracked=128, device="cpu")
    assert (tracker.num_slots, mapper.num_slots) == (1128, 1256)
    for ex, frame in ((tracker, room), (mapper, room), (other, small),
                      (again, room)):
        ex.detect_and_extract(frame)
    assert [(e["width"], e["height"], e["slots"], e["calls"])
            for e in cache.buckets()] == [(752, 480, 1128, 2),
                                          (752, 480, 1256, 1),
                                          (W, H, other.num_slots, 1)]


def test_interleaved_prefetches_of_two_geometries(cache, frames):
    """Prefetches of two geometries issued in turn, then collected, equal
    direct calls: no geometry's buffers or outputs leak into the other's."""
    a = F.OrbExtractor(_settings(), W, H, max_tracked=16, device="cpu")
    b = F.OrbExtractor(_settings(), W, H, max_tracked=48, device="cpu")
    issued = []
    for i, frame in enumerate(frames[:4]):
        for ex in (a, b):
            xy, ids = _tracked(i + (ex is b), ex.max_tracked)
            ex.prefetch(i, frame, xy, ids)
            issued.append((ex, i, frame, xy))
    for ex, i, frame, xy in issued:
        _assert_equal(ex.detect_and_extract(None, key=i),
                      _direct(ex, frame, xy), f"slots {ex.num_slots}, {i}")
    assert [e["calls"] for e in cache.buckets()] == [4, 4]


# ---------------------------------------------------------------------------
# on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_replays_bit_equal_to_eager_for_both_room_extractors_on_card(
        cache, monkeypatch):
    """The tracker's and the Mapper's 752x480 extractors over 24 rendered
    frames: each extraction through the cache (eager, captured, then
    replayed) equals the eager path on fresh tensors in all six outputs,
    with one K1 launch per extraction."""
    _need_card()
    from slam_tpu_torch.kernels import hamming_argmin as kernel

    launches = []
    launch = kernel.launch

    def counted(desc, codebook):
        launches.append(tuple(desc.shape))
        return launch(desc, codebook)

    monkeypatch.setattr(kernel, "launch", counted)
    s = _settings(keypoints=1000)
    room = _frames(24, 752, 480)
    tracker = F.OrbExtractor(s, 752, 480, max_tracked=128, device="cuda")
    mapper = F.OrbExtractor(s, 752, 480, max_tracked=256, device="cuda")
    prev = None
    for i, frame in enumerate(room):
        xy = None if prev is None or i % 5 == 0 else prev
        for ex in (tracker, mapper):
            pts = xy if ex is mapper else None
            n = len(launches)
            if ex is mapper:
                ex.prefetch(i, frame, pts)
                got = ex.detect_and_extract(None, key=i)
            else:
                got = ex.detect_and_extract(frame, pts)
            assert len(launches) == n + 1, (i, launches[n:])
            _assert_equal(got, _direct(ex, frame, pts, "cuda"),
                          f"frame {i}, slots {ex.num_slots}")
        prev = got.pts[got.valid][:256]
    c = cache.counters()
    assert (c["buckets"], c["eager_runs"], c["captures"], c["replays"]) == \
        (2, 2, 2, 2 * 23)
    assert sorted(set(launches)) == [(1128, 8), (1256, 8)]


@pytest.mark.cuda
def test_capture_while_another_thread_replays_a_ba_graph_on_card(cache):
    """An extraction geometry is captured while another thread replays a BA
    bucket over and over; the capture succeeds, its replay equals the eager
    path, and the BA's replays equal its eager twin."""
    _need_card()
    from slam_tpu_torch.ops import ba
    from test_torch_ba_graph import BUCKETS, _card_problem, _equal

    ba.BA_GRAPHS.clear()
    args = _card_problem(0, BUCKETS[1])
    want = ba.solve_ba_two_stage_eager(*args, 5, 0)
    ba.solve_ba_two_stage(*args, 5, 0)
    ba.solve_ba_two_stage(*args, 5, 0)                     # captured
    (frame,) = _frames(1, 752, 480)
    ex = F.OrbExtractor(_settings(keypoints=1000), 752, 480,
                        max_tracked=256, device="cuda")
    ex.detect_and_extract(frame)
    stop, runs, errors = threading.Event(), [], []

    def solve():
        try:
            while not stop.is_set():
                got = ba.solve_ba_two_stage(*args, 5, 0)
                torch.cuda.current_stream().synchronize()
                runs.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        except Exception as e:      # re-raised below, in the test's thread
            errors.append(e)

    t = threading.Thread(target=solve)
    t.start()
    try:
        while not runs and t.is_alive():
            stop.wait(0.01)
        n0 = len(runs)
        got = ex.detect_and_extract(frame)                 # the capture
        again = ex.detect_and_extract(frame)               # a replay
        during = len(runs) - n0
    finally:
        stop.set()
        t.join()
        ba.BA_GRAPHS.clear()
    assert not errors, errors
    assert cache.counters()["captures"] == 1
    want_x = _direct(ex, frame, None, "cuda")
    _assert_equal(got, want_x, "captured geometry")
    _assert_equal(again, want_x, "replayed geometry")
    assert all(runs) and during > 0, (runs, during)
    _equal(ba.solve_ba_two_stage_eager(*args, 5, 0), want, "BA twin")
