"""Parity of the torch port's ORB front-end with the JAX package on CPU.

The spec is the JAX front-end's own golden tests (tests/test_frontend.py
with tests/ref_orb.py): pyramid levels within +/-1 gray (rint ties where
two libraries sum the band products in another order), orientation within
1e-2 degrees, descriptors bit-exact. Against the JAX extractor the keypoint
slots (pts, octave, valid) must be equal, and the descriptors equal wherever
both packages built the same pyramid level. Both detectors are covered."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import orb as jorb
from slam_tpu.ops.frontend import _extract_impl, _min_distances
from slam_tpu.ops.pyramid import (_build_pyramid_impl, _pyramid_operators,
                                  level_sizes)
from slam_tpu.params import Parameters, ParametersSlam, StaticSettings
from slam_tpu_torch.ops import orb as torb
from slam_tpu_torch.ops.frontend import FrontendSpec, extract
from slam_tpu_torch.ops.pyramid import build_pyramid, pyramid_operators
from slam_tpu_torch.utils.synthetic import make_world, render_frame

import ref_orb

torch.set_num_threads(1)
W, H = 320, 240


def _random_image(rng, h=H, w=W):
    img = rng.integers(0, 256, size=(h, w)).astype(np.float64)
    return np.rint(ref_orb.ref_gaussian_blur_7x7_s2(img)).astype(np.uint8)


def _rendered_image():
    from slam_tpu.geometry.camera import default_camera
    world = make_world(n_frames=2, n_landmarks=500, seed=30,
                       trajectory="loop", lap_frames=32,
                       camera=default_camera(W, H))
    patches = np.random.default_rng(31).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    return render_frame(world, patches, 1, W, H)


def _spec(detector):
    settings = StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=300, slamFeatureDetector=detector)))
    p = settings.parameters.slam
    scales = tuple(float(s) for s in settings.scaleFactors)
    sizes = level_sizes(W, H, scales)
    return FrontendSpec(scales, tuple(settings.maxNumberOfKeypointsPerLevel()),
                        tuple(_min_distances(settings, sizes)),
                        int(p.orbLkTrackLevel), detector == "fast", W, H)


def _pyramids(img, spec):
    sizes, rs, bs = _pyramid_operators(W, H, spec.scale_factors)
    j_lv, j_bl = _build_pyramid_impl(jnp.asarray(img, jnp.float32), rs, bs)
    _, rs_t, bs_t = pyramid_operators(W, H, spec.scale_factors)
    put = lambda ops: [(torch.from_numpy(r), torch.from_numpy(c))
                       for r, c in ops]
    t_lv, t_bl = build_pyramid(torch.from_numpy(img).float()[None],
                               put(rs_t), put(bs_t))
    return ([np.asarray(x) for x in j_lv], [np.asarray(x) for x in j_bl],
            [x[0].numpy() for x in t_lv], [x[0].numpy() for x in t_bl])


def test_pyramid_within_one_gray():
    rng = np.random.default_rng(7)
    spec = _spec("")
    for img in (_random_image(rng), _rendered_image()):
        j_lv, j_bl, t_lv, t_bl = _pyramids(img, spec)
        for a, b in zip(j_lv + j_bl, t_lv + t_bl):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1.0
            assert np.mean(a != b) < 1e-3


def test_orb_pieces_match_reference_math():
    """The port's angle and descriptor against the scalar reference
    (tests/ref_orb.py), as tests/test_frontend.py holds the JAX kernels."""
    rng = np.random.default_rng(8)
    img = _random_image(rng, 120, 160)
    n = 40
    pts = np.stack([rng.integers(20, 140, n), rng.integers(20, 100, n)], -1)
    patches = torb.extract_patches(torch.from_numpy(img).float()[None],
                                   torch.from_numpy(pts).float()[None])
    ang = torb.ic_angles(patches)[0].numpy()
    want_ang = [ref_orb.ref_ic_angle(img, int(x), int(y)) for x, y in pts]
    np.testing.assert_allclose(ang, want_ang, atol=1e-2)
    angles = rng.uniform(0, 360, n).astype(np.float32)
    desc = torb.descriptors_from_patches(
        patches, torch.from_numpy(angles)[None])[0].numpy().view(np.uint32)
    for i, (x, y) in enumerate(pts):
        want = ref_orb.bytes_to_words(
            ref_orb.ref_descriptor(img, int(x), int(y), angles[i]))
        np.testing.assert_array_equal(desc[i], want)
    # the JAX kernels agree on the same patches
    j_desc = np.asarray(jorb.descriptors_from_patches(
        jnp.asarray(patches[0].numpy()), jnp.asarray(angles)))
    np.testing.assert_array_equal(desc, j_desc)


def test_fast_trig_matches_jax():
    v = np.random.default_rng(9).uniform(-20, 20, 500).astype(np.float32)
    np.testing.assert_array_equal(torb.fast_cos(torch.from_numpy(v)).numpy(),
                                  np.asarray(jorb.fast_cos(v)))
    np.testing.assert_array_equal(torb.fast_sin(torch.from_numpy(v)).numpy(),
                                  np.asarray(jorb.fast_sin(v)))
    y, x = v[:250] * 50, v[250:] * 50
    np.testing.assert_allclose(
        torb.fast_atan2_deg(torch.from_numpy(y), torch.from_numpy(x)).numpy(),
        np.asarray(jorb.fast_atan2_deg(y, x)), atol=1e-4)
    np.testing.assert_array_equal(torb.u_max_table(), jorb.u_max_table())


_TXY = np.array([[100.0, 100.0], [200.0, 150.0], [5.0, 5.0]] + [[0, 0]] * 5,
                np.float32)
_TVALID = np.array([True, True, True] + [False] * 5)


def _assert_features_equal(got, s, j_pts, j_oct, j_ang, j_desc, j_valid,
                           desc_ok):
    np.testing.assert_array_equal(got.pts[s].numpy(), j_pts)
    np.testing.assert_array_equal(got.octave[s].numpy(), j_oct)
    np.testing.assert_array_equal(got.valid[s].numpy(), j_valid)
    assert j_valid.sum() > 100
    np.testing.assert_allclose(got.angle[s].numpy()[j_valid], j_ang[j_valid],
                               atol=1e-2)
    keep = j_valid & desc_ok
    assert keep.sum() > 0.9 * j_valid.sum()
    np.testing.assert_array_equal(got.desc[s].numpy().view(np.uint32)[keep],
                                  j_desc[keep])


@pytest.mark.parametrize("detector", ["", "fast"], ids=["gftt", "fast"])
def test_extract_matches_jax_on_rendered_frame(detector):
    """The whole front-end on the main path's kind of input (a rendered
    frame of the synthetic world), against the JAX extractor."""
    spec = _spec(detector)
    img = _rendered_image()
    got = extract(torch.from_numpy(img)[None], torch.from_numpy(_TXY)[None],
                  torch.from_numpy(_TVALID)[None], spec)
    j_pts, j_oct, j_ang, j_desc, j_valid, _ = (np.asarray(x) for x in
        _extract_impl(jnp.asarray(img, jnp.float32), jnp.asarray(_TXY),
                      jnp.asarray(_TVALID), tuple(spec) + (0,)))
    # descriptors on the slots whose pyramid level both packages built
    # identically (level and blurred level)
    j_lv, j_bl, t_lv, t_bl = _pyramids(img, spec)
    same = np.array([np.array_equal(a, b) and np.array_equal(c, d)
                     for a, b, c, d in zip(j_lv, t_lv, j_bl, t_bl)])
    _assert_features_equal(got, 0, j_pts, j_oct, j_ang, j_desc, j_valid,
                           same[j_oct])


@pytest.mark.parametrize("detector", ["", "fast"], ids=["gftt", "fast"])
def test_detection_and_orb_match_jax_on_shared_pyramid(detector):
    """Detection, orientation and descriptors on random images, both
    packages fed the JAX pyramid. (Built separately, the pyramids differ
    by one gray at a few rint ties per level, which can reorder corners
    of nearly equal strength nearby.)"""
    from slam_tpu.ops import detector as jdet
    from slam_tpu_torch.ops.frontend import extract_from_pyramid

    rng = np.random.default_rng(10)
    spec = _spec(detector)
    imgs = [_random_image(rng), _random_image(rng)]
    pyrs = [_pyramids(img, spec)[:2] for img in imgs]
    sizes = level_sizes(W, H, spec.scale_factors)
    stack = lambda lists: [torch.from_numpy(np.stack(x)) for x in zip(*lists)]
    got = extract_from_pyramid(stack([p[0] for p in pyrs]),
                               stack([p[1] for p in pyrs]), sizes,
                               torch.from_numpy(np.stack([_TXY, _TXY])),
                               torch.from_numpy(np.stack([_TVALID, _TVALID])),
                               spec)

    def jax_level(lvl_img, lvl_blur, budget, min_dist):
        # the per-level body of the JAX package's _extract_impl
        q = jnp.rint(jnp.clip(lvl_img, 0.0, 255.0))
        resp = jdet.fast_response(q) if spec.use_fast \
            else jdet.shi_tomasi_response(q)
        xy, _, valid = jdet.select_keypoints(resp, budget, min_dist)
        ang, desc = jorb.compute_orb(lvl_img, lvl_blur, xy)
        return xy, ang, desc, valid

    level = jax.jit(jax_level, static_argnums=(2, 3))
    for s, (lv, bl) in enumerate(pyrs):
        lk = spec.lk_level
        t_xy = jnp.rint(jnp.asarray(_TXY) / np.float32(spec.scale_factors[lk]))
        t_ang, t_desc = jorb.compute_orb(jnp.asarray(lv[lk]),
                                         jnp.asarray(bl[lk]), t_xy)
        parts = [(_TXY, np.full(8, lk), np.asarray(t_ang), np.asarray(t_desc),
                  got.valid[s].numpy()[:8])]
        for lvl in range(len(lv)):
            xy, ang, desc, valid = (np.asarray(x) for x in level(
                jnp.asarray(lv[lvl]), jnp.asarray(bl[lvl]),
                spec.budgets[lvl], spec.min_dists[lvl]))
            parts.append((xy * np.float32(spec.scale_factors[lvl]),
                          np.full(len(xy), lvl), ang, desc, valid))
        j_pts, j_oct, j_ang, j_desc, j_valid = (np.concatenate(x)
                                                for x in zip(*parts))
        _assert_features_equal(got, s, j_pts, j_oct.astype(np.int32), j_ang,
                               j_desc, j_valid, np.ones(len(j_valid), bool))
