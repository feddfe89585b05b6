"""GFTT detection as one hand-written CUDA kernel (``csrc/gftt_peaks.cu``
behind ``ops/detector.gftt_peaks``).

On the CPU: the wrapper's plain path equals the composition the front-end
ran before the kernel (quantisation, ``shi_tomasi_response``, the max-pool
peak test, the margin, the ``where``), bit for bit; ``select_keypoints``,
now ``take_best`` over ``peak_map``, gives the same points, scores and
validity as before, ties included; a CPU call launches nothing and the
timer's ``detect.launch`` stays 0; the binding refuses what the kernel
cannot take before it builds anything; each thread keeps its own tally, and
a capture takes the launches it recorded back out for its replays to add.

The ``cuda`` tests import no JAX and run on the card:

    python -m pytest tests/test_torch_gftt_kernel.py --noconftest -m cuda

They hold the kernel's masked maps bit-equal to the plain version, on the
card and on the CPU, at every level of the three geometries the cells run
(752x480 with S = 8 and S = 1, 1241x376 with S = 1), at 1920x1200, on
images made to break it (flat, saturated 0/255, a checkerboard of tied
scores, random non-integer and out-of-range values, ragged sizes, every min
distance) and at min distances from 9 up to the largest whose tile fits in
a block's shared memory, which is refused one above; and a replayed chunk and a replayed extraction bit-equal to their eager
twins and to the same work with the plain detection, with ``detect.launch``
counting the launches that ran: one a frame step.
"""
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from slam_tpu_torch.kernels import gftt_peaks as kernel
from slam_tpu_torch.kernels import launches
from slam_tpu_torch.ops import detector as det
from slam_tpu_torch.ops import frontend as F
from slam_tpu_torch.ops.pyramid import build_pyramid
from slam_tpu_torch.params import (ORB_PATCH_RADIUS, Parameters,
                                   ParametersSlam, StaticSettings)
from slam_tpu_torch.utils import timer
from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                            render_frame)

torch.set_num_threads(1)


def _before_masked(response, min_distance, margin=ORB_PATCH_RADIUS):
    """The front-end's masked map as ``select_keypoints`` built it before
    the split."""
    S, h, w = response.shape
    md = max(int(min_distance), 1)
    pooled = TF.max_pool2d(response[:, None], kernel_size=2 * md + 1,
                           stride=1, padding=md)[:, 0]
    is_peak = (response >= pooled) & (response > 0.0)
    row = torch.arange(h, device=response.device)[:, None]
    col = torch.arange(w, device=response.device)[None, :]
    in_margin = ((row >= margin) & (row < h - margin)
                 & (col >= margin) & (col < w - margin))
    return torch.where(is_peak & in_margin, response,
                       torch.full_like(response, -float("inf")))


def _before_select(response, budget, min_distance, margin=ORB_PATCH_RADIUS):
    """``select_keypoints`` as it was before the split."""
    S, h, w = response.shape
    masked = _before_masked(response, min_distance, margin)
    scores, idx = torch.sort(masked.reshape(S, -1), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :budget], idx[:, :budget]
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    valid = torch.isfinite(scores) & (scores > 0.0)
    xy = torch.stack([xs, ys], dim=-1)
    return xy, torch.where(valid, scores, torch.zeros_like(scores)), valid


def _before_level(img, min_distance, margin=ORB_PATCH_RADIUS):
    """What ``extract_from_pyramid`` computed for one GFTT level before the
    kernel."""
    q = torch.round(torch.clamp(img, 0.0, 255.0))
    return _before_masked(det.shi_tomasi_response(q), min_distance, margin)


def _breakers(seed=5):
    """{name: ((S, H, W) float32 image, min distance)}: images made to break
    the kernel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:120, 0:160]
    board = np.where(((yy // 4) + (xx // 4)) % 2 == 0, 255.0, 0.0)
    out = {
        "flat": (np.full((2, 96, 128), 128.0), 3),
        "saturated": (rng.choice([0.0, 255.0], (2, 96, 128)), 2),
        "checkerboard": (np.stack([board, board[::-1]]), 4),
        "fine_checkerboard": (
            np.stack([np.where((yy + xx) % 2 == 0, 255.0, 0.0)] * 2), 1),
        "random_real": (rng.uniform(-40.0, 300.0, (2, 120, 160)), 4),
        "ragged": (rng.uniform(0.0, 255.0, (3, 77, 101)), 3),
        "below_margin": (rng.uniform(0.0, 255.0, (2, 30, 45)), 2),
        "single_pixel_tiles": (rng.uniform(0.0, 255.0, (1, 17, 33)), 1),
        "wide_window": (rng.integers(0, 256, (2, 81, 130)).astype(float), 8),
        "half_steps": (rng.integers(0, 512, (2, 64, 96)) / 2.0, 5),
    }
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).float(), md)
            for k, (v, md) in out.items()}


def _frames(n, w, h, seed=31):
    world = make_world(n_frames=n, n_landmarks=500, seed=seed,
                       trajectory="loop", lap_frames=64,
                       camera=default_camera(w, h))
    patches = np.random.default_rng(seed).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    return np.stack([render_frame(world, patches, i, w, h)
                     for i in range(n)])


def _levels(images, device, gftt_min_distance=7.0):
    """The (S, H_l, W_l) pyramid levels and the GFTT min distances of the
    front-end's settings (by default the defaults) at the images' size."""
    h, w = images.shape[-2:]
    settings = StaticSettings(Parameters(slam=ParametersSlam(
        gfttMinDistance=gftt_min_distance)))
    scale_factors = tuple(float(s) for s in settings.scaleFactors)
    spec_sizes, rs, bs = F.device_operators(w, h, scale_factors,
                                            torch.device(device))
    levels, _ = build_pyramid(
        torch.from_numpy(images).to(device).float(), rs, bs)
    return levels, F.min_distances(settings, spec_sizes)


# ---------------------------------------------------------------------------
# on the CPU


@pytest.mark.parametrize("name", sorted(_breakers()))
def test_plain_path_equals_the_composition_before(name):
    img, md = _breakers()[name]
    got = det.gftt_peaks([img], [md])
    assert len(got) == 1
    assert torch.equal(got[0], _before_level(img, md)), name


def test_plain_path_equals_the_composition_before_on_a_pyramid():
    levels, mds = _levels(_frames(2, 320, 240), "cpu")
    got = det.gftt_peaks(levels, mds)
    assert [tuple(m.shape) for m in got] == [tuple(t.shape) for t in levels]
    for lvl, (m, img, md) in enumerate(zip(got, levels, mds)):
        assert torch.equal(m, _before_level(img, md)), lvl
    assert sum(int(torch.isfinite(m).sum()) for m in got) > 100


@pytest.mark.parametrize("budget,md", [(50, 3), (400, 1), (7, 5)])
def test_select_keypoints_split_gives_the_same_points(budget, md):
    """Integer responses with many ties, so the stable sort's order shows."""
    rng = np.random.default_rng(budget)
    resp = torch.from_numpy(rng.integers(-3, 6, (3, 70, 90))).float()
    want = _before_select(resp, budget, md)
    for got in (det.select_keypoints(resp, budget, md),
                det.take_best(det.peak_map(resp, md), budget)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert int(want[2].sum()) > 0


def test_cpu_calls_launch_nothing():
    levels, mds = _levels(_frames(1, 320, 240), "cpu")
    settings = StaticSettings(Parameters(slam=ParametersSlam()))
    ex = F.OrbExtractor(settings, 320, 240, max_tracked=16, device="cpu")
    before = launches.GFTT.total
    stats = timer.enable_timing()
    try:
        det.gftt_peaks(levels, mds)
        F.extract(torch.from_numpy(_frames(1, 320, 240)),
                  torch.zeros(1, 16, 2), torch.zeros(1, 16, dtype=torch.bool),
                  ex._spec)
        counted = stats.counts.get("detect.launch", 0)
    finally:
        timer.disable_timing()
    assert launches.GFTT.total == before
    assert counted == 0
    assert det.gftt_peaks([], []) == []


@pytest.mark.parametrize("case", ["cpu_tensor", "md_zero", "md_huge",
                                  "int_dtype", "two_batches", "no_levels"])
def test_binding_refuses_what_the_kernel_cannot_take(case):
    """Checked in Python before the library is built or loaded."""
    a = torch.zeros(2, 40, 50)
    levels, mds = {
        "cpu_tensor": ([a], [2]),
        "md_zero": ([a], [0]),
        "md_huge": ([a], [10 ** 6]),
        "int_dtype": ([a.int()], [2]),
        "two_batches": ([a, torch.zeros(3, 20, 25)], [2, 1]),
        "no_levels": ([], []),
    }[case]
    with pytest.raises(ValueError):
        kernel.launch(levels, mds, ORB_PATCH_RADIUS)


def test_each_thread_keeps_its_own_tally():
    """A capture reads its own thread's tally, so launches counted on
    other threads meanwhile do not land in its graph's count."""
    before, seen = launches.GFTT.total, []

    def other():
        launches.GFTT.add(5)
        seen.append(launches.GFTT.thread_total())

    mine = launches.GFTT.thread_total()
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    try:
        assert seen == [5]
        assert launches.GFTT.thread_total() == mine
        assert launches.GFTT.total == before + 5
    finally:
        launches.GFTT.add(-5)


def test_capture_takes_its_launches_back_out_and_replay_adds_them():
    """What a capture records is taken back out of every counter and of
    the timer; launches of another thread meanwhile stay counted and are
    not the capture's; each replay adds the recorded launches again."""
    totals = [c.total for c in launches.COUNTERS]
    names = [c.name for c in launches.COUNTERS]
    assert names == ["k1.launch", "detect.launch", "orb.launch"]
    stats = timer.enable_timing()
    try:
        with launches.capture() as recorded:
            launches.K1.add(2)
            launches.GFTT.add(3)
            launches.ORB.add(1)
            t = threading.Thread(target=launches.GFTT.add, args=(7,))
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
        assert recorded == {"k1.launch": 2, "detect.launch": 3,
                            "orb.launch": 1}
        assert [c.total for c in launches.COUNTERS] == [totals[0],
                                                        totals[1] + 7,
                                                        totals[2]]
        assert [stats.counts[n] for n in names] == [0, 7, 0]
        for _ in range(2):
            launches.replay(recorded)
        assert [c.total for c in launches.COUNTERS] == [totals[0] + 4,
                                                        totals[1] + 13,
                                                        totals[2] + 2]
        assert [stats.counts[n] for n in names] == [4, 13, 2]
    finally:
        timer.disable_timing()
        launches.K1.add(-4)
        launches.GFTT.add(-13)
        launches.ORB.add(-2)
    assert [c.total for c in launches.COUNTERS] == totals


def test_capture_that_raises_takes_its_launches_back_out():
    totals = [c.total for c in launches.COUNTERS]
    with pytest.raises(RuntimeError):
        with launches.capture() as recorded:
            launches.GFTT.add(1)
            raise RuntimeError("capture failed")
    assert recorded == {"detect.launch": 1}
    assert [c.total for c in launches.COUNTERS] == totals


# ---------------------------------------------------------------------------
# on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _assert_maps_equal(got, want, what):
    assert len(got) == len(want), what
    for lvl, (a, b) in enumerate(zip(got, want)):
        a, b = a.cpu(), b.cpu()
        bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        assert bad == 0, f"{what}, level {lvl}: {bad} pixels differ"


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(752, 480, 8), (752, 480, 1),
                                      (1241, 376, 1), (1920, 1200, 1)])
def test_kernel_bit_equal_at_every_level_on_card(geometry):
    """One launch for all levels, bit-equal to the plain version on the card
    and on the CPU. At 1920x1200 the first level's min distance is 9."""
    _need_card()
    w, h, s = geometry
    levels, mds = _levels(_frames(s, w, h), "cuda")
    before = launches.GFTT.total
    got = det.gftt_peaks(levels, mds)
    torch.cuda.synchronize()
    assert launches.GFTT.total == before + 1
    _assert_maps_equal(got, det.gftt_peaks_plain(levels, mds), "card plain")
    _assert_maps_equal(got, det.gftt_peaks_plain([t.cpu() for t in levels],
                                                 mds), "CPU plain")
    assert sum(int(torch.isfinite(m).sum()) for m in got) > 100 * s


@pytest.mark.cuda
def test_kernel_bit_equal_on_breaking_images_on_card():
    """Each image alone, then all of them as the levels of one launch."""
    _need_card()
    cases = _breakers()
    for name, (img, md) in cases.items():
        got = det.gftt_peaks([img.cuda()], [md])
        _assert_maps_equal(got, [_before_level(img, md)], name)
    same_s = [(img, md) for img, md in cases.values() if img.shape[0] == 2]
    got = det.gftt_peaks([img.cuda() for img, _ in same_s],
                         [md for _, md in same_s])
    _assert_maps_equal(got, [_before_level(img, md) for img, md in same_s],
                       "one launch")


@pytest.mark.cuda
@pytest.mark.parametrize("md", [9, 10, 11, 12, 18, 19, 32, "largest"])
def test_kernel_bit_equal_at_large_min_distances_on_card(md):
    """Min distances above the 48 KB a block takes unasked from 19 on, up
    to the largest that fits: each level alone and all in one launch."""
    _need_card()
    largest = kernel.max_min_distance(torch.device("cuda"))
    assert largest >= 40, largest
    md = largest if md == "largest" else md
    levels, _ = _levels(_frames(2, 752, 480), "cuda")
    mds = [max(1, md - lvl) for lvl in range(len(levels))]
    got = det.gftt_peaks(levels, mds)
    _assert_maps_equal(got, det.gftt_peaks_plain(levels, mds), f"md {md}")
    for img, m in zip(levels[:2], mds):
        _assert_maps_equal(det.gftt_peaks([img], [m]),
                           det.gftt_peaks_plain([img], [m]), f"md {m} alone")


@pytest.mark.cuda
@pytest.mark.parametrize("gftt_min_distance", [16.0, 40.0, 100.0])
def test_kernel_bit_equal_at_wide_min_distance_settings_on_card(
        gftt_min_distance):
    """``gfttMinDistance`` above the default at 752x480: min distances 9,
    21 and 53 on the first level."""
    _need_card()
    levels, mds = _levels(_frames(2, 752, 480), "cuda", gftt_min_distance)
    assert mds[0] > 8, mds
    _assert_maps_equal(det.gftt_peaks(levels, mds),
                       det.gftt_peaks_plain(levels, mds),
                       f"gfttMinDistance {gftt_min_distance}")


@pytest.mark.cuda
def test_kernel_refuses_a_min_distance_that_cannot_fit_on_card():
    _need_card()
    largest = kernel.max_min_distance(torch.device("cuda"))
    img = torch.zeros(1, 64, 64, device="cuda")
    before = launches.GFTT.total
    with pytest.raises(ValueError, match="shared memory"):
        det.gftt_peaks([img, img], [1, largest + 1])
    assert launches.GFTT.total == before


@pytest.mark.cuda
def test_extract_at_1920x1200_equals_the_plain_detection_on_card(
        monkeypatch):
    """The whole front-end step at 1920x1200 (min distance 9 on the first
    level) with the kernel and with the plain detection."""
    _need_card()
    settings = StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=1000, bowVocabularySize=0)))
    ex = F.OrbExtractor(settings, 1920, 1200, max_tracked=16, device="cuda")
    assert ex._spec.min_dists[0] == 9, ex._spec.min_dists
    image = torch.from_numpy(_frames(2, 1920, 1200)).cuda()
    txy = torch.zeros(2, 16, 2, device="cuda")
    tv = torch.zeros(2, 16, dtype=torch.bool, device="cuda")
    got = F.extract(image, txy, tv, ex._spec)
    with monkeypatch.context() as m:
        m.setattr(det, "gftt_peaks", det.gftt_peaks_plain)
        want = F.extract(image, txy, tv, ex._spec)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    assert int(got.valid.sum()) > 500


def _chunk_scene(w=320, h=240, seqs=2, t=4, chunks=3):
    from slam_tpu_torch.utils.synthetic import exact_odometry

    cam = default_camera(w, h)
    worlds = [make_world(n_frames=t * chunks, n_landmarks=500, seed=30 + i,
                         trajectory="loop", lap_frames=32, camera=cam)
              for i in range(seqs)]
    patches = np.random.default_rng(1).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    images = np.stack([np.stack([render_frame(wd, patches, i, w, h)
                                 for i in range(t * chunks)])
                       for wd in worlds])
    deltas = np.stack([exact_odometry(wd, t * chunks) for wd in worlds])
    p0 = np.stack([wd.poses_cw[0] for wd in worlds]).astype(np.float32)
    return cam, images, deltas, p0


@pytest.mark.cuda
def test_chunk_replay_counts_its_launches_on_card(monkeypatch):
    """The chunk graph's replays equal the eager twin and the eager chunk
    with the plain detection; ``detect.launch`` counts one launch a frame
    step on each side, the capture's recorded launches taken back out."""
    _need_card()
    from slam_tpu_torch.pipeline import device_vo as tvo

    w, h, seqs, t, chunks = 320, 240, 2, 4, 3
    cam, images, deltas, p0 = _chunk_scene(w, h, seqs, t, chunks)
    cfg = tvo.DeviceVOConfig(width=w, height=h, lm_capacity=128,
                             max_keypoints=300, window=4, window_ba_every=4,
                             loop_every=2, loop_slots=8, loop_words=64,
                             loop_min_gap=2, loop_points=16)

    def vo():
        v = tvo.BatchedDeviceVO(cfg, batch=seqs, camera=cam, device="cuda")
        v.reset(p0)
        return v

    graphed, twin, plain = vo(), vo(), vo()
    stats = timer.enable_timing()
    try:
        for c in range(chunks):
            sl = slice(c * t, (c + 1) * t)
            chunk = (images[:, sl], deltas[:, sl])
            for runner in (graphed.advance, twin._advance_eager):
                n0 = launches.GFTT.total
                c0 = stats.counts.get("detect.launch", 0)
                out = runner(*chunk)
                torch.cuda.synchronize()
                assert launches.GFTT.total - n0 == t, (c, runner)
                assert stats.counts["detect.launch"] - c0 == t, (c, runner)
                if runner == graphed.advance:
                    got = out
            with monkeypatch.context() as m:
                m.setattr(det, "gftt_peaks", det.gftt_peaks_plain)
                want = plain._advance_eager(*chunk)
            for a, b, d in ((got, out, "twin"), (got, want, "plain")):
                bad = [f for f, x, y in zip(a._fields, a, b)
                       if not torch.equal(x.cpu(), y.cpu())]
                assert not bad, f"chunk {c} against the {d}: {bad}"
    finally:
        timer.disable_timing()
    (shape,) = graphed._chunks[0].graphs.buckets()
    assert shape["graph"] and shape["launches"]["detect.launch"] == t


@pytest.mark.cuda
def test_extraction_replay_counts_its_launches_on_card(monkeypatch):
    """The interactive extraction's graph at 752x480: each extraction (eager,
    captured, replayed) equals ``extract`` with the plain detection in all
    five outputs, with one launch counted per extraction that ran: the
    capturing call runs the extraction once on a side stream, records it
    (counted, then taken back out) and replays it."""
    _need_card()
    F.EXTRACT_GRAPHS.clear()
    settings = StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=1000, bowVocabularySize=0)))
    ex = F.OrbExtractor(settings, 752, 480, max_tracked=128, device="cuda")
    frames = _frames(5, 752, 480)
    txy = torch.zeros(1, 128, 2, device="cuda")
    tv = torch.zeros(1, 128, dtype=torch.bool, device="cuda")
    try:
        for i, frame in enumerate(frames):
            n0 = launches.GFTT.total
            got = ex.detect_and_extract(frame)
            assert launches.GFTT.total - n0 == (2 if i == 1 else 1), i
            with monkeypatch.context() as m:
                m.setattr(det, "gftt_peaks", det.gftt_peaks_plain)
                want = F.extract(torch.from_numpy(frame).cuda()[None], txy,
                                 tv, ex._spec)
            for name, a, b in (("pts", got.pts, want.pts[0]),
                               ("octave", got.octave, want.octave[0]),
                               ("angle", got.angle, want.angle[0]),
                               ("valid", got.valid, want.valid[0])):
                np.testing.assert_array_equal(a, b.cpu().numpy(),
                                              err_msg=f"frame {i}: {name}")
            np.testing.assert_array_equal(
                got.descriptors, want.desc[0].cpu().numpy().view(np.uint32))
        c = F.EXTRACT_GRAPHS.counters()
        assert (c["captures"], c["replays"]) == (1, len(frames) - 1)
    finally:
        F.EXTRACT_GRAPHS.clear()
