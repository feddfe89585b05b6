"""The port's front-end at the rendered-sequence tools' geometries, the
EuRoC-class room (752x480) and the KITTI-class street (1241x376, the first
odd width through the pyramid), against the JAX package on CPU: band
matrices bit-equal, pyramids within one gray, and on a shared pyramid the
extractor's slots, descriptors and words equal at the tools' slot counts
(``DescriptorTracker``'s 128 + 1,000, the ``Mapper``'s 256 + 1,000), with
orientation within 1e-2 degrees; then the trackers' ids frame by frame on
shared front-end results."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_tools_shared import share_jax_pyramid

import torch_run_euroc_synthetic as teuroc
import torch_run_kitti_synthetic as tkitti
from slam_tpu.ops import frontend as jfront
from slam_tpu.ops.pyramid import _build_pyramid_impl, _pyramid_operators
from slam_tpu.params import Parameters as JParameters
from slam_tpu.params import ParametersSlam as JParametersSlam
from slam_tpu.params import StaticSettings as JStaticSettings
from slam_tpu_torch.ops import frontend as tfront
from slam_tpu_torch.ops.pyramid import build_pyramid, pyramid_operators
from slam_tpu_torch.params import Parameters, ParametersSlam, StaticSettings

torch.set_num_threads(1)


def _street_frames(n):
    scene = tkitti.make_street_scene(0)
    _, poses = tkitti.make_sequence(n)
    return [teuroc.render(scene, p, cam=tkitti.CAM) for p in poses]


@pytest.fixture(scope="module")
def frames():
    room = teuroc.render(teuroc.make_scene(0),
                         teuroc.make_sequence(8)[1][3])
    return {"room": (room, 752, 480), "street": (_street_frames(1)[0], 1241,
                                                 376)}


@pytest.mark.parametrize("name", ["room", "street"])
def test_band_matrices_equal_and_pyramid_within_one_gray(frames, name):
    img, w, h = frames[name]
    key = tuple(float(s) for s in StaticSettings().scaleFactors)
    sj, rj, bj = _pyramid_operators(w, h, key)
    st, rt, bt = pyramid_operators(w, h, key)
    assert [tuple(s) for s in sj] == [tuple(s) for s in st]
    for a, b in zip(rj + bj, rt + bt):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
    lj, _ = _build_pyramid_impl(jnp.asarray(img, jnp.float32), rj, bj)
    put = lambda ops: [tuple(torch.from_numpy(m) for m in op) for op in ops]
    lt, _ = build_pyramid(torch.from_numpy(img)[None].float(), put(rt),
                          put(bt))
    for a, b in zip(lj, lt):
        assert np.abs(np.asarray(a) - b[0].numpy()).max() <= 1.0


@pytest.mark.parametrize("name,max_tracked", [("room", 128), ("street", 128),
                                              ("street", 256)])
def test_extraction_equal_on_shared_pyramid(frames, name, max_tracked,
                                            monkeypatch):
    img, w, h = frames[name]
    want = jfront.OrbExtractor(JStaticSettings(JParameters(
        slam=JParametersSlam())), w, h, max_tracked=max_tracked
    ).detect_and_extract(img)
    share_jax_pyramid(monkeypatch)
    ex = tfront.OrbExtractor(StaticSettings(Parameters(
        slam=ParametersSlam())), w, h, max_tracked=max_tracked, device="cpu")
    got = ex.detect_and_extract(img)
    assert ex.num_slots == max_tracked + 1000 == len(want.pts)
    np.testing.assert_array_equal(got.pts, want.pts)
    np.testing.assert_array_equal(got.octave, want.octave)
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    assert v.sum() > 600
    np.testing.assert_allclose(got.angle[v], want.angle[v], atol=1e-2)
    np.testing.assert_array_equal(got.descriptors, want.descriptors)
    np.testing.assert_array_equal(got.words, want.words)


class _Replay:
    """An extractor stand-in that returns recorded results in turn."""

    def __init__(self, results):
        self._results = list(results)

    def detect_and_extract(self, image, *args, **kw):
        return self._results.pop(0)


def test_street_track_ids_equal_on_shared_features():
    """Both packages' ``DescriptorTracker`` on the JAX extractor's results
    for three street frames (with the blackout's blank frame between the
    second and third): equal ids, positions and fresh ids, and the blank
    frame resets every track."""
    from slam_tpu.frontends.descriptor_tracker import \
        DescriptorTracker as JTracker
    from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker
    from slam_tpu_torch.ops.frontend import FrontendResult

    street = _street_frames(2)
    blank = np.full((376, 1241), 18, np.uint8)
    seq = [street[0], street[1], blank, street[1]]
    ex = jfront.OrbExtractor(JStaticSettings(JParameters(
        slam=JParametersSlam())), 1241, 376, max_tracked=128)
    jres = [ex.detect_and_extract(f) for f in seq]
    tres = [FrontendResult(**{k: (None if v is None else np.copy(v))
                              for k, v in dataclasses.asdict(r).items()})
            for r in jres]
    state = dict(max_tracks=128, match_threshold=50, lowe_ratio=0.8,
                 max_motion_px=80.0, _next_id=0, _prev=None,
                 _prev_track_ids=None)
    jt = JTracker.__new__(JTracker)
    jt.__dict__.update(state, extractor=_Replay(jres))
    tt = DescriptorTracker.__new__(DescriptorTracker)
    tt.__dict__.update(state, extractor=_Replay(tres))
    out = []
    for f in seq:
        a, b = jt.process(f), tt.process(f)
        np.testing.assert_array_equal(b.track_ids, a.track_ids)
        np.testing.assert_array_equal(b.tracked_id_list, a.tracked_id_list)
        np.testing.assert_array_equal(b.tracked_pts, a.tracked_pts)
        out.append(set(b.tracked_id_list.tolist()))
    assert len(out[0] & out[1]) > 30          # tracks carry between frames
    assert not out[2]                         # nothing to track in the dark
    assert not (out[3] & out[1])              # the blackout reset them all
    assert tt._next_id == jt._next_id
