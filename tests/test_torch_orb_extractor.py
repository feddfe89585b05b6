"""Parity of the port's ``OrbExtractor`` (the interactive path's front-end,
with the fused BoW words at the 65,536-word vocabulary) with the JAX
package's on CPU, on a rendered 640x480 frame of the synthetic world.

Integer outputs are compared for equality: with both packages fed the JAX
pyramid, slots (pts, octave, valid), descriptors and words are equal;
with each package building its own pyramid (they differ by one gray at a
few rint ties), words are equal wherever descriptors are. Orientation is
held within 1e-2 degrees, as in tests/test_torch_frontend.py. A prefetched
frame collects the same result as a direct call."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import frontend as jfront
from slam_tpu.ops.pyramid import _build_pyramid_impl, _pyramid_operators
from slam_tpu.params import Parameters as JParameters
from slam_tpu.params import ParametersSlam as JParametersSlam
from slam_tpu.params import StaticSettings as JStaticSettings
from slam_tpu_torch.ops import frontend as tfront
from slam_tpu_torch.params import Parameters, ParametersSlam, StaticSettings
from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                            render_frame)

torch.set_num_threads(1)
W, H = 640, 480
TRACKED = np.array([[100.0, 100.0], [200.0, 150.0], [320.5, 240.25],
                    [5.0, 5.0]], np.float32)
TRACK_IDS = np.array([11, 12, 13, 14])


@pytest.fixture(scope="module")
def frame():
    world = make_world(n_frames=2, n_landmarks=500, seed=31,
                       trajectory="loop", lap_frames=64,
                       camera=default_camera(W, H))
    patches = np.random.default_rng(31).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    return render_frame(world, patches, 0, W, H)


@pytest.fixture(scope="module")
def jax_result(frame):
    settings = JStaticSettings(JParameters(slam=JParametersSlam(
        maxKeypoints=600)))
    ex = jfront.OrbExtractor(settings, W, H)
    return ex.detect_and_extract(frame, TRACKED, TRACK_IDS)


def _port_extractor():
    settings = StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=600)))
    return tfront.OrbExtractor(settings, W, H, device="cpu")


def _jax_pyramid(image, spec):
    _, rs, bs = _pyramid_operators(W, H, spec.scale_factors)
    levels, blurred = _build_pyramid_impl(jnp.asarray(image, jnp.float32),
                                          rs, bs)
    return levels, blurred


def test_slots_descriptors_and_words_equal_on_shared_pyramid(
        frame, jax_result, monkeypatch):
    ex = _port_extractor()

    def shared_pyramid(image, resize_ops, blur_ops):
        lv, bl = _jax_pyramid(np.asarray(image[0]), ex._spec)
        put = lambda xs: [torch.from_numpy(np.array(x))[None] for x in xs]
        return put(lv), put(bl)

    monkeypatch.setattr(tfront, "build_pyramid", shared_pyramid)
    got = ex.detect_and_extract(frame, TRACKED, TRACK_IDS)
    want = jax_result
    assert got.pts.shape == (ex.num_slots, 2) == want.pts.shape
    assert ex.num_slots == 256 + 600
    np.testing.assert_array_equal(got.pts, want.pts)
    np.testing.assert_array_equal(got.octave, want.octave)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.track_ids, want.track_ids)
    assert want.valid.sum() > 300
    v = want.valid
    np.testing.assert_allclose(got.angle[v], want.angle[v], atol=1e-2)
    assert got.descriptors.dtype == np.uint32
    np.testing.assert_array_equal(got.descriptors, want.descriptors)
    assert got.words.dtype == np.int32
    np.testing.assert_array_equal(got.words, want.words)
    assert len(np.unique(got.words[v])) > 100


def test_words_equal_wherever_descriptors_are(frame, jax_result):
    got = _port_extractor().detect_and_extract(frame, TRACKED, TRACK_IDS)
    want = jax_result
    same = (got.descriptors == want.descriptors).all(axis=1)
    assert same.mean() > 0.9, same.mean()
    np.testing.assert_array_equal(got.words[same], want.words[same])
    # the words are the nearest vocabulary rows of the port's descriptors
    from slam_tpu_torch.ops import bow
    cb = bow.make_codebook(65536)
    v = got.valid
    np.testing.assert_array_equal(
        got.words[v], bow.quantize(got.descriptors[v], cb, "cpu"))


def test_prefetch_then_collect_equals_a_direct_call(frame):
    ex = _port_extractor()
    direct = ex.detect_and_extract(frame, TRACKED, TRACK_IDS)
    ex.prefetch(7, frame, TRACKED, TRACK_IDS)
    assert ex.extractions == 2 and 7 in ex._pending
    collected = ex.detect_and_extract(None, None, None, key=7)
    assert 7 not in ex._pending and ex.extractions == 2
    for name in ("pts", "octave", "angle", "descriptors", "valid",
                 "track_ids", "words"):
        np.testing.assert_array_equal(getattr(collected, name),
                                      getattr(direct, name), err_msg=name)
    # the tracked-point buffers are reused while their contents hold
    buf = ex._dev_txy
    ex.detect_and_extract(frame, TRACKED.copy(), TRACK_IDS)
    assert ex._dev_txy is buf
