"""ORB orientation and rotated-BRIEF descriptors as one hand-written CUDA
kernel (``csrc/orb_describe.cu`` behind ``ops/orb.orb_features``).

On the CPU: the plain ``orb_features`` equals ``compute_orb`` a group and
``torch.cat``, and ``extract_from_pyramid`` (every level's keypoints taken
first, then one ``orb_features`` call) gives what it gave before (one
``compute_orb`` a group, four concatenations), with the GFTT and the FAST
detector; the kernel's tables and float32 constants, read from its source,
are the plain version's; the binding refuses what the kernel cannot take,
each case for its own reason, before it builds anything; ``orb.launch`` is
one of the counters a capture takes back out, and a CPU call launches
nothing; the crafted patches of the card tests give flat moments and angles
in every quadrant and on every axis.

The ``cuda`` tests import no JAX and run on the card:

    python -m pytest tests/test_torch_orb_kernel.py --noconftest -m cuda

They hold the kernel bit-equal to the plain version (angles as bit
patterns, descriptors exactly), on the card and on the CPU, at the fleet's
step (S = 8, 752x480, 8 tracked slots and 600 detected), the room's live
extraction (752x480, 256 tracked slots and 1,000) and the street's
(1241x376); at S = 1 and S = 0, with keypoints on and outside the border,
invalid tracked filler, groups of no slots, levels of 20 to 38 px (the
plain version's patches wrap round), flat patches and patches in every
quadrant; and a CUDA-graph capture and replay of
``extract_from_pyramid`` equal to its eager run and to the plain version,
with ``orb.launch`` counted at capture, taken back out and added per replay.
"""
import re

import numpy as np
import pytest
import torch

from slam_tpu_torch.kernels import launches
from slam_tpu_torch.kernels import orb_describe as kernel
from slam_tpu_torch.kernels.build import CSRC_DIR
from slam_tpu_torch.ops import detector as det
from slam_tpu_torch.ops import frontend as F
from slam_tpu_torch.ops import orb
from slam_tpu_torch.ops.orb_pattern import ORB_PATTERN
from slam_tpu_torch.ops.pyramid import build_pyramid
from slam_tpu_torch.params import Parameters, ParametersSlam, StaticSettings
from slam_tpu_torch.pipeline.device_vo import N_TRACKED, _frontend_spec
from slam_tpu_torch.utils import timer
from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                            render_frame)

torch.set_num_threads(1)
SOURCE = CSRC_DIR / "orb_describe.cu"
# (width, height, images, maxKeypoints, tracked slots): the fleet's step,
# the room's live extraction (the Mapper's 1,256 slots) and the street's
GEOMETRIES = {"fleet": (752, 480, 8, 600, N_TRACKED),
              "room": (752, 480, 1, 1000, 256),
              "street": (1241, 376, 1, 1000, 256)}


def _frames(n, w, h, seed=31):
    world = make_world(n_frames=n, n_landmarks=500, seed=seed,
                       trajectory="loop", lap_frames=64,
                       camera=default_camera(w, h))
    patches = np.random.default_rng(seed).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    return np.stack([render_frame(world, patches, i, w, h)
                     for i in range(n)])


def _spec(w, h, keypoints, detector="GFTT"):
    return _frontend_spec(StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=keypoints, slamFeatureDetector=detector))), w, h)


def _tracked(S, n, w, h, seed=3):
    """(S, n, 2) float32 tracked points in full-resolution pixels: inside,
    on and outside the border, the front-end's filler (0, 0) and far
    outside."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform([-40.0, -40.0], [w + 40.0, h + 40.0], (S, n, 2))
    if n >= 4:
        xy[:, 0] = 0.0
        xy[:, 1] = (-1e6, 1e6)
        xy[:, 2] = (w - 1.0, h - 1.0)
        xy[:, 3] = (19.4, h - 19.6)
    return torch.from_numpy(xy.astype(np.float32))


def _pyramid(frames, spec, device):
    sizes, rs, bs = F._operators(spec, torch.device(device))
    levels, blurred = build_pyramid(
        torch.as_tensor(frames).to(device).float(), rs, bs)
    return sizes, levels, blurred


def _step_groups(frames, spec, n_tracked, device):
    """The groups ``extract_from_pyramid`` hands ``orb_features`` for
    ``frames``: the tracked points at the LK level, then each level's
    best keypoints."""
    S, h, w = frames.shape
    sizes, levels, blurred = _pyramid(frames, spec, device)
    lk = spec.lk_level
    txy = _tracked(S, n_tracked, w, h).to(device)
    scale = float(np.float32(spec.scale_factors[lk]))
    groups = [(levels[lk], blurred[lk], torch.round(txy / scale))]
    lvls = [lvl for lvl, b in enumerate(spec.budgets) if b > 0]
    maps = det.gftt_peaks([levels[lvl] for lvl in lvls],
                          [spec.min_dists[lvl] for lvl in lvls])
    for lvl, masked in zip(lvls, maps):
        xy, _, _ = det.take_best(masked, spec.budgets[lvl])
        groups.append((levels[lvl], blurred[lvl], xy))
    return groups


def _before_extract(levels, blurred, sizes, tracked_xy, tracked_valid, spec):
    """``extract_from_pyramid`` as it was before ``orb_features``: one
    ``compute_orb`` a group, between the detections."""
    S = levels[0].shape[0]
    dev = levels[0].device
    pts, octs, angs, descs, valids = [], [], [], [], []
    lk = spec.lk_level
    lk_scale = float(np.float32(spec.scale_factors[lk]))
    lk_w, lk_h = sizes[lk]
    xi = torch.round(tracked_xy[..., 0] / lk_scale)
    yi = torch.round(tracked_xy[..., 1] / lk_scale)
    m = F.ORB_PATCH_RADIUS
    t_ok = (tracked_valid & (xi >= m) & (yi >= m) & (xi < lk_w - m)
            & (yi < lk_h - m))
    a, d = orb.compute_orb(levels[lk], blurred[lk],
                           torch.stack([xi, yi], dim=-1))
    pts.append(tracked_xy)
    octs.append(torch.full(t_ok.shape, lk, dtype=torch.int32, device=dev))
    angs.append(a)
    descs.append(d)
    valids.append(t_ok)
    lvls = [lvl for lvl, b in enumerate(spec.budgets) if b > 0]
    mds = [spec.min_dists[lvl] for lvl in lvls]
    if spec.use_fast:
        maps = [det.peak_map(det.fast_response(F.quantise(levels[lvl])), md)
                for lvl, md in zip(lvls, mds)]
    else:
        maps = det.gftt_peaks([levels[lvl] for lvl in lvls], mds)
    for lvl, masked in zip(lvls, maps):
        xy, _, valid = det.take_best(masked, spec.budgets[lvl])
        a, d = orb.compute_orb(levels[lvl], blurred[lvl], xy)
        pts.append(xy * float(np.float32(spec.scale_factors[lvl])))
        octs.append(torch.full((S, spec.budgets[lvl]), lvl,
                               dtype=torch.int32, device=dev))
        angs.append(a)
        descs.append(d)
        valids.append(valid)
    return F.Features(*(torch.cat(x, 1)
                        for x in (pts, octs, angs, descs, valids)))


# (name, (h, w) image as a function of (y, x) relative to the patch centre):
# flat, one exact axis and a quadrant each
def _crafted(size=64):
    c = size // 2
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) - c
    ramps = {
        "flat": np.full_like(xx, 117.0),
        "east": 100 + 3 * xx, "north": 100 - 3 * yy,
        "west": 100 - 3 * xx, "south": 100 + 3 * yy,
        "diagonal": 100 + 2 * xx + 2 * yy,
        "quadrant_1": 100 + 3 * xx + 1 * yy,
        "quadrant_2": 100 - 1 * xx + 3 * yy,
        "quadrant_3": 100 - 3 * xx - 2 * yy,
        "quadrant_4": 100 + 2 * xx - 3 * yy,
        "half_steps": 100.5 + 0.5 * xx - 1.5 * yy,
        "saturated": np.where(xx + 2 * yy > 0, 300.0, -20.0),
    }
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in
            ramps.items()}


def _crafted_groups(device):
    """One group of every crafted image (S = 1, its centre, the border and
    beyond), a group of random pixels with no slots, and levels of 20 to 38
    px on a side, where the plain version's patches wrap round."""
    imgs = _crafted()
    c = 32
    xy = torch.tensor([[[c, c], [c + 0.9, c - 0.9], [19.0, 44.0],
                        [-3.0, 70.0], [200.0, -200.0]]])
    groups = [(img[None].to(device).contiguous(),
               img[None].to(device).contiguous(), xy.to(device))
              for img in imgs.values()]
    rng = np.random.default_rng(2)
    noise = torch.from_numpy(rng.uniform(0, 255, (1, 50, 40)).astype(
        np.float32)).to(device)
    groups.append((noise, noise.clone(), torch.zeros(1, 0, 2, device=device)))
    for h, w in ((20, 20), (33, 45), (38, 38), (24, 90)):
        img = torch.from_numpy(rng.uniform(-20, 280, (1, h, w)).astype(
            np.float32)).to(device)
        xy = torch.from_numpy(rng.uniform(-10, 100, (1, 6, 2)).astype(
            np.float32)).to(device)
        groups.append((img, img.flip(-1).contiguous(), xy))
    return groups


def _stacked_crafted(device):
    imgs = torch.stack(list(_crafted().values())).to(device)
    xy = torch.tensor([[32.0, 32.0], [31.2, 33.7]]).expand(
        imgs.shape[0], 2, 2).contiguous().to(device)
    return [(imgs, imgs.flip(-1).contiguous(), xy)]


# ---------------------------------------------------------------------------
# on the CPU


@pytest.mark.parametrize("geometry", [(320, 240, 2, 300, 16),
                                      (160, 120, 1, 150, 4)])
def test_plain_equals_compute_orb_per_group_and_cat(geometry):
    w, h, S, keypoints, n_tracked = geometry
    spec = _spec(w, h, keypoints)
    groups = _step_groups(_frames(S, w, h), spec, n_tracked, "cpu")
    per_group = [orb.compute_orb(*g) for g in groups]
    want = (torch.cat([a for a, _ in per_group], 1),
            torch.cat([d for _, d in per_group], 1))
    for got in (orb.orb_features_plain(groups), orb.orb_features(groups)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    n = sum(g[2].shape[1] for g in groups)
    assert want[0].shape == (S, n) and want[1].shape == (S, n, 8)
    assert want[1].dtype == torch.int32


@pytest.mark.parametrize("detector", ["GFTT", "FAST"])
def test_extract_from_pyramid_gives_what_it_gave_before(detector):
    w, h, S = 320, 240, 2
    spec = _spec(w, h, 300, detector)
    frames = _frames(S, w, h)
    sizes, levels, blurred = _pyramid(frames, spec, "cpu")
    txy = _tracked(S, 16, w, h)
    tv = torch.from_numpy(np.random.default_rng(4).random((S, 16)) < 0.7)
    got = F.extract_from_pyramid(levels, blurred, sizes, txy, tv, spec)
    want = _before_extract(levels, blurred, sizes, txy, tv, spec)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    assert int(got.valid.sum()) > 100


def test_plain_takes_no_images_and_groups_of_no_slots():
    groups = _crafted_groups("cpu")
    n = sum(g[2].shape[1] for g in groups)
    assert [g[2].shape[1] for g in groups].count(0) == 1
    ang, desc = orb.orb_features(groups)
    assert ang.shape == (1, n) and desc.shape == (1, n, 8)
    assert torch.equal(ang[:, :5], orb.compute_orb(*groups[0])[0])
    empty = [(g[0][:0], g[1][:0], g[2][:0]) for g in groups]
    ang, desc = orb.orb_features(empty)
    assert ang.shape == (0, n) and desc.shape == (0, n, 8)
    with pytest.raises(ValueError):
        orb.orb_features([])


def test_crafted_patches_cover_every_branch_of_the_angle():
    """Flat moments (0/0), each axis, the diagonal tie and each quadrant:
    the inputs the card's edge test holds the kernel to."""
    imgs = _crafted()
    ang, _ = orb.orb_features([
        (img[None], img[None], torch.tensor([[[32.0, 32.0]]]))
        for img in imgs.values()])
    got = dict(zip(imgs, ang[0].tolist()))
    assert got["flat"] == 0.0
    assert abs(got["east"] - 0.0) < 1e-3 or abs(got["east"] - 360) < 1e-3
    assert abs(got["south"] - 90.0) < 1e-3
    assert abs(got["west"] - 180.0) < 1e-3
    assert abs(got["north"] - 270.0) < 1e-3
    assert abs(got["diagonal"] - 45.0) < 0.1
    for q, (lo, hi) in enumerate([(0, 90), (90, 180), (180, 270),
                                  (270, 360)], 1):
        assert lo < got[f"quadrant_{q}"] < hi, (q, got)


def test_orb_counter_is_listed_and_cpu_calls_launch_nothing():
    assert launches.ORB in launches.COUNTERS
    assert launches.ORB.name == "orb.launch"
    w, h = 160, 120
    spec = _spec(w, h, 150)
    before = launches.ORB.total
    stats = timer.enable_timing()
    try:
        orb.orb_features(_step_groups(_frames(1, w, h), spec, 4, "cpu"))
        F.extract(torch.from_numpy(_frames(1, w, h)), torch.zeros(1, 4, 2),
                  torch.zeros(1, 4, dtype=torch.bool), spec)
        counted = stats.counts.get("orb.launch", 0)
    finally:
        timer.disable_timing()
    assert launches.ORB.total == before
    assert counted == 0


def _refused(case):
    a = torch.zeros(2, 40, 50)
    xy = torch.zeros(2, 3, 2)
    return {
        "no_groups": [],
        "too_many_groups": [(a, a, xy)] * (kernel.MAX_GROUPS + 1),
        "double_image": [(a.double(), a, xy)],
        "non_contiguous_image": [(torch.zeros(2, 50, 40).transpose(1, 2),
                                  a, xy)],
        "two_dimensional_image": [(a[0], a[0], xy)],
        "blurred_of_another_size": [(a, torch.zeros(2, 40, 51), xy)],
        "narrow_level": [(torch.zeros(2, 40, 19),) * 2 + (xy,)],
        "short_level": [(torch.zeros(2, 19, 50),) * 2 + (xy,)],
        "mismatched_images": [(a, a, xy),
                              (torch.zeros(3, 40, 50),) * 2 + (xy,)],
        "mismatched_keypoint_images": [(a, a, torch.zeros(3, 3, 2))],
        "integer_keypoints": [(a, a, xy.long())],
        "keypoints_not_pairs": [(a, a, torch.zeros(2, 3, 3))],
        "non_contiguous_keypoints": [(a, a, torch.zeros(2, 2, 3).transpose(
            1, 2))],
        "cpu_tensors": [(a, a, xy)],
    }[case]


@pytest.mark.parametrize("case,reason", [
    ("no_groups", "groups"), ("too_many_groups", "groups"),
    ("double_image", "float32"), ("non_contiguous_image", "contiguous"),
    ("two_dimensional_image", r"\(S, H, W\)"),
    ("blurred_of_another_size", "against level"),
    ("narrow_level", "20 px"), ("short_level", "20 px"),
    ("mismatched_images", "S = 2"),
    ("mismatched_keypoint_images", "S = 2"),
    ("integer_keypoints", "float32"), ("keypoints_not_pairs", r"\(S, N, 2\)"),
    ("non_contiguous_keypoints", "contiguous"), ("cpu_tensors", "CUDA")])
def test_binding_refuses_what_the_kernel_cannot_take(case, reason):
    """Checked in Python before the library is built or loaded; every case
    but the last is refused for its own reason before the device is
    looked at."""
    with pytest.raises(ValueError, match=reason):
        kernel.launch(_refused(case))


def _source_array(name):
    text = SOURCE.read_text()
    body = re.search(name + r"\[[^\]]*\] = \{(.*?)\};", text, re.S).group(1)
    return [int(v) for v in re.findall(r"-?\d+", body)]


def _source_float(name):
    m = re.search(r"constexpr float " + name + r" = (-?0x[0-9a-fp.+-]+)f;",
                  SOURCE.read_text())
    return float.fromhex(m.group(1))


@pytest.mark.parametrize("table", ["pattern", "u_max", "constants"])
def test_kernel_source_holds_the_plain_versions_numbers(table):
    """The kernel cannot run here; its tables and float32 constants are
    read from its source and held to the plain version's."""
    if table == "pattern":
        got = np.array(_source_array("kPattern")).reshape(256, 4)
        np.testing.assert_array_equal(got, ORB_PATTERN)
    elif table == "u_max":
        assert _source_array("kUMax") == orb.u_max_table().tolist()
        w10, w01 = orb._moment_weights()
        inside = (w10 != 0) | (w01 != 0)
        um = orb.u_max_table()
        for dv in range(-15, 16):
            for du in range(-15, 16):
                if du or dv:
                    assert inside[dv + 15, du + 15] == (abs(du)
                                                        <= um[abs(dv)])
    else:
        plain = {"kAtanP1": orb._ATAN2_P1, "kAtanP3": orb._ATAN2_P3,
                 "kAtanP5": orb._ATAN2_P5, "kAtanP7": orb._ATAN2_P7,
                 "kDblEps": orb._DBL_EPS, "kPi": orb._PI,
                 "kHalfPi": orb._PI_2, "kTwoPi": orb._TWO_PI,
                 "kInvTwoPi": orb._INV_TWO_PI,
                 "kThreeHalfPi": orb._THREE_PI_2,
                 "kCos0": 0.99940307, "kCos2": -0.49558072,
                 "kCos4": 0.03679168, "kDegToRad": np.pi / 180.0}
        for name, value in plain.items():
            assert _source_float(name) == float(np.float32(value)), name


# ---------------------------------------------------------------------------
# on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _assert_equal(got, want, what):
    a, d = (t.cpu() for t in got)
    wa, wd = (t.cpu() for t in want)
    assert a.shape == wa.shape and d.shape == wd.shape, what
    bad = int((a.view(torch.int32) != wa.view(torch.int32)).sum())
    assert bad == 0, f"{what}: {bad} angles differ"
    bad = int((d != wd).any(-1).sum())
    assert bad == 0, f"{what}: {bad} descriptors differ"


def _kernel_run(groups):
    before = launches.ORB.total
    got = orb.orb_features(groups)
    torch.cuda.synchronize()
    return got, launches.ORB.total - before


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_kernel_bit_equal_at_the_cells_geometries_on_card(name):
    _need_card()
    w, h, S, keypoints, n_tracked = GEOMETRIES[name]
    spec = _spec(w, h, keypoints)
    groups = _step_groups(_frames(S, w, h), spec, n_tracked, "cuda")
    got, ran = _kernel_run(groups)
    assert ran == 1
    _assert_equal(got, orb.orb_features_plain(groups), f"{name}, card")
    _assert_equal(got, orb.orb_features_plain(
        [tuple(t.cpu() for t in g) for g in groups]), f"{name}, CPU")
    assert got[0].shape == (S, n_tracked + sum(spec.budgets))


@pytest.mark.cuda
def test_kernel_bit_equal_on_edge_inputs_on_card():
    """Flat and quadrant patches, centres on and beyond the border, a group
    of no slots, levels of 20 to 38 px; the images stacked as S = 12 with
    another blurred level; S = 0, which launches nothing."""
    _need_card()
    for what, groups in (("crafted", _crafted_groups("cuda")),
                         ("stacked", _stacked_crafted("cuda"))):
        got, ran = _kernel_run(groups)
        assert ran == 1, what
        _assert_equal(got, orb.orb_features_plain(groups), what)
        _assert_equal(got, orb.orb_features_plain(
            [tuple(t.cpu() for t in g) for g in groups]), f"{what}, CPU")
    groups = _crafted_groups("cuda")
    got, ran = _kernel_run([(g[0][:0], g[1][:0], g[2][:0]) for g in groups])
    assert ran == 0 and got[0].shape == (0, sum(g[2].shape[1]
                                                for g in groups))


@pytest.mark.cuda
def test_extract_replay_equals_eager_and_counts_launches_on_card(
        monkeypatch):
    """``extract_from_pyramid`` at the fleet's step captured as a CUDA
    graph: each replay, the last on other frames copied into the graph's
    input levels, equals the eager run and the plain version in all five
    outputs; the capture's launch is taken back out and each replay adds
    one."""
    _need_card()
    w, h, S, keypoints, n_tracked = GEOMETRIES["fleet"]
    spec = _spec(w, h, keypoints)
    frames = _frames(S + 2, w, h)
    sizes, levels, blurred = _pyramid(frames[:S], spec, "cuda")
    txy = _tracked(S, n_tracked, w, h).cuda()
    tv = torch.ones(S, n_tracked, dtype=torch.bool, device="cuda")

    def run():
        return F.extract_from_pyramid(levels, blurred, sizes, txy, tv, spec)

    run()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    n0 = launches.ORB.total
    with launches.capture() as recorded, torch.cuda.graph(g):
        out = run()
    assert recorded == {"detect.launch": 1, "orb.launch": 1}, recorded
    assert launches.ORB.total == n0
    for i in range(3):
        if i == 2:
            _, lv, bl = _pyramid(frames[2:], spec, "cuda")
            for dst, src in zip(levels + blurred, lv + bl):
                dst.copy_(src)
        want = run()
        with monkeypatch.context() as m:
            m.setattr(orb, "orb_features", orb.orb_features_plain)
            plain = run()
        g.replay()
        launches.replay(recorded)
        torch.cuda.synchronize()
        for name, a, b, c in zip(out._fields, out, want, plain):
            assert torch.equal(a, b), (i, name, "eager")
            assert torch.equal(a, c), (i, name, "plain")
    assert launches.ORB.total == n0 + 6
    assert int(out.valid.sum()) > 1000
