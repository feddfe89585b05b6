"""The port's multi-device helpers and update step
(``slam_tpu_torch/parallel/{mesh,multichip}.py``) on CPU devices: the
reference's ``TestMultichipStep`` (tests/test_native_and_misc.py:300-376)
over eight CPU devices as a (4, 2) mesh, the pair chain beside the JAX
package's ``_pair_step_impl`` on shared features (the JAX extractor's
output) with the JAX hypothesis banks injected, and the sharded step
beside the one-device step. Integer outputs (inlier counts) are equal;
each test states its float tolerance."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_synthetic_world as tworld
from slam_tpu.geometry.camera import default_camera as jdefault_camera
from slam_tpu.ops import camera_jax
from slam_tpu.ops.frontend import _extract_impl, _min_distances
from slam_tpu.ops.pyramid import level_sizes
from slam_tpu.ops import ransac as jransac
from slam_tpu.parallel import multichip as jmultichip
from slam_tpu.params import Parameters as JParameters
from slam_tpu.params import ParametersSlam as JParametersSlam
from slam_tpu.params import StaticSettings as JStaticSettings
from slam_tpu_torch.ops import camera as camera_ops
from slam_tpu_torch.parallel import multichip
from slam_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                          replicated, shard_batch)

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


def _render_pairs(n=8, max_kp=200):
    """The reference test's textured dot field at two nearby positions,
    frames i % 4 of a line world (tests/test_native_and_misc.py:347-368)."""
    world = tworld.make_world(n_frames=4, n_landmarks=300, seed=3,
                              trajectory="line")
    rng = np.random.default_rng(7)
    patches = rng.integers(40, 255, (300, 9, 9)).astype(np.uint8)
    w, h = world.camera.width, world.camera.height

    def render(i):
        img = np.full((h, w), 20, np.uint8)
        vis, pix = tworld.visible_landmarks(world, i, margin=6.0)
        for li in vis:
            x, y = int(round(pix[li, 0])), int(round(pix[li, 1]))
            y0, y1 = max(0, y - 4), min(h, y + 5)
            x0, x1 = max(0, x - 4), min(w, x + 5)
            img[y0:y1, x0:x1] = patches[li][:y1 - y0, :x1 - x0]
        return img
    return world, np.stack([render(i % 4) for i in range(n)]).astype(
        np.float32)


def jax_sampler(ess_keys, sim3_keys):
    """The banks the JAX package's cores draw from the (B, K, 2) key banks
    of ``make_key_banks``, for each pair the shard holds."""
    @jax.jit
    def bank(keys, p, size_probe):
        size = size_probe.shape[0]
        return jax.vmap(lambda k: jax.random.choice(
            k, p.shape[0], shape=(size,), replace=False, p=p / jnp.sum(p)))(
                keys)

    def sample(valid, size, pairs):
        keys = ess_keys if size == 8 else sim3_keys
        v = valid.cpu().numpy().astype(np.float32)
        out = [np.asarray(bank(keys[b], v[j], np.zeros(size)))
               for j, b in enumerate(pairs)]
        return torch.from_numpy(np.stack(out).astype(np.int64)).to(
            valid.device)
    return sample


# --- the mesh helpers

def test_make_mesh_shapes_and_shards():
    mesh = make_mesh(8, axis_names=("data", "hyp"), devices=CPU8)
    assert dict(mesh.shape) == {"data": 4, "hyp": 2}
    assert dict(make_mesh(8, devices=CPU8).shape) == {"data": 8}
    assert dict(make_mesh(6, ("data", "hyp"), devices=CPU8).shape) == {
        "data": 3, "hyp": 2}
    assert len(batch_sharding(mesh).devices) == 4
    assert len(replicated(mesh).devices) == 8
    x = np.arange(8 * 3).reshape(8, 3)
    parts = shard_batch(mesh, x)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    with pytest.raises(ValueError):
        shard_batch(mesh, x[:7])


def test_make_mesh_refuses_missing_cuda_devices():
    """No CPU fallback: asking for more CUDA devices than exist raises."""
    with pytest.raises(RuntimeError, match="need"):
        make_mesh(torch.cuda.device_count() + 1)


# --- the reference's TestMultichipStep on the port

def test_sharded_update_step_8_devices():
    mesh = make_mesh(8, axis_names=("data", "hyp"), devices=CPU8)
    step = multichip.build_update_step(mesh, 96, 80, hypotheses=16,
                                       ba_capacity=16)
    images = np.random.default_rng(9).integers(0, 256, (8, 80, 96)).astype(
        np.float32)
    out = step(images)
    costs = out.ba_cost.numpy()
    assert costs.shape == (8,) and np.isfinite(costs).all()
    assert out.keypoints.shape[0] == 8
    assert tuple(out.poses.shape) == (8, 2, 4, 4)


def test_uses_production_kernels():
    """The step runs the same functions as the one-device pipeline, not
    multichip-only twins."""
    assert not hasattr(multichip, "_batched_pyramid")
    assert not hasattr(multichip, "tiny_ba_problem")
    src = inspect.getsource(multichip)
    for sym in ("extract(", "hamming_matrix(", "mutual_nn(",
                "essential_ransac_core(", "sim3_ransac_core(",
                "recover_pose_from_E(", "ba.lm_run("):
        assert sym in src, f"production function {sym} not used"


def test_pair_step_recovers_known_motion():
    world, images = _render_pairs()
    w, h = world.camera.width, world.camera.height
    mesh = make_mesh(8, axis_names=("data", "hyp"), devices=CPU8)
    step = multichip.build_update_step(mesh, w, h, hypotheses=32,
                                       ba_capacity=32, max_keypoints=200,
                                       camera=world.camera)
    out = step(images)
    ess = out.essential_inliers.numpy()
    assert (ess >= 8).all(), ess
    assert np.isfinite(out.ba_cost.numpy()).all()


# --- parity

@pytest.fixture(scope="module")
def shared_features():
    """The JAX extractor's features of the rendered frames (the pyramid's
    +-1 gray ties of the two packages must not decide the test)."""
    world, images = _render_pairs()
    w, h = world.camera.width, world.camera.height
    settings = JStaticSettings(JParameters(slam=JParametersSlam(
        maxKeypoints=200)))
    p = settings.parameters.slam
    sf = tuple(float(s) for s in settings.scaleFactors)
    sizes = level_sizes(w, h, sf)
    spec = (sf, tuple(settings.maxNumberOfKeypointsPerLevel()),
            tuple(_min_distances(settings, sizes)), int(p.orbLkTrackLevel),
            p.slamFeatureDetector.lower() == "fast", w, h, 0)
    txy = jnp.zeros((8, 2), jnp.float32)
    tv = jnp.zeros((8,), bool)
    feats = [_extract_impl(jnp.asarray(img), txy, tv, spec)
             for img in images]
    pts = np.stack([np.asarray(f[0]) for f in feats])
    valid = np.stack([np.asarray(f[4]) for f in feats])
    desc = np.stack([np.asarray(f[3]) for f in feats])
    return world, pts, valid, desc


def _jax_chain(world, pts, valid, desc, ke, ks, ba_capacity):
    """The JAX package's chain on the shared features, and the winner of
    its essential RANSAC per pair (its core on its own bearings and
    bank, the computation its chain runs)."""
    kind, params = camera_jax.pack_camera(jdefault_camera(
        world.camera.width, world.camera.height))
    params = jnp.asarray(params)
    fa = (jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(desc))
    fb = tuple(jnp.roll(x, -1, axis=0) for x in fa)
    run = jax.jit(jax.vmap(lambda a, b, e, s: jmultichip._pair_step(
        a, b, e, s, kind, params, ba_capacity, 3)))

    def essential(a, b, keys):
        nn, real_good = jmultichip._mutual_match(a[2], b[2], a[1], b[1])
        good = jnp.where(jnp.sum(real_good) < 8, jnp.ones_like(real_good),
                         real_good)
        b1 = camera_jax.unproject(kind, params, a[0])
        b2 = camera_jax.unproject(kind, params, b[0][nn])
        with jax.default_matmul_precision("highest"):
            return jransac._essential_ransac_core(keys, b1, b2, good)
    ke, ks = jnp.asarray(ke), jnp.asarray(ks)
    chain = [np.asarray(x) for x in run(fa, fb, ke, ks)]
    winner = [np.asarray(x) for x in jax.jit(jax.vmap(essential))(fa, fb, ke)]
    return chain, winner


def test_pair_chain_matches_jax_on_shared_features(shared_features,
                                                   monkeypatch):
    """The port's chain on the JAX features and banks. The essential
    RANSAC's winner is the JAX package's (its 8-point solves on
    near-degenerate octets are LAPACK rounding, and its score ranks them:
    tests/test_torch_ransac.py holds the core itself); from there every
    stage is the port's. Inlier counts are equal. The pair BA runs three
    LM iterations on points triangulated from rays 0.12 m apart at 3-8 m,
    where a depth moves by centimetres for a rounding-sized change of a
    bearing, and the two packages' bearings differ by that rounding; so
    the floats are held loosely: poses within 2e-2, costs within 5e-2
    relative, each pair's median point within 0.25 m (tests/test_torch_ba.py
    holds the LM itself to 1e-4 on shared problems)."""
    world, pts, valid, desc = shared_features
    K, M = 32, 32
    ke, ks = jmultichip.make_key_banks(8, K, seed=1)
    want, (jE, jscore, jinl) = _jax_chain(world, pts, valid, desc, ke, ks, M)
    sampler = jax_sampler(ke, ks)
    fa = (torch.from_numpy(pts), torch.from_numpy(valid),
          torch.from_numpy(desc.view(np.int32)))
    fb = tuple(torch.roll(x, -1, dims=0) for x in fa)
    kind, params = camera_ops.pack_camera(world.camera)
    pairs = np.arange(8)
    banks = []

    def jax_winner(idx, b1, b2, valid):
        banks.append(idx)
        return (torch.from_numpy(jE), torch.from_numpy(jscore),
                torch.from_numpy(jinl))
    monkeypatch.setattr(multichip, "essential_ransac_core", jax_winner)
    got = multichip.pair_chain(fa, fb, lambda v: sampler(v, 8, pairs),
                               lambda v: sampler(v, 3, pairs), kind,
                               torch.from_numpy(params), M, 3)
    assert tuple(banks[0].shape) == (8, K, 8)
    ess, s3, poses, points, cost = (t.numpy() for t in got)
    np.testing.assert_array_equal(ess, want[0])
    assert (ess >= 8).all()
    np.testing.assert_array_equal(s3, want[1])
    np.testing.assert_allclose(poses, want[2], atol=2e-2)
    assert (np.median(np.abs(points - want[3]).max(-1), axis=1) < 0.25).all()
    np.testing.assert_allclose(cost, want[4], rtol=5e-2)


def test_sharded_step_equals_one_device(shared_features):
    """The same banks per pair: the (4, 2) mesh's step, whose last frame of
    each shard pairs across devices, equals the one-device step."""
    world, images = _render_pairs()
    w, h = world.camera.width, world.camera.height
    ke, ks = jmultichip.make_key_banks(8, 16, seed=2)
    outs = []
    for mesh in (make_mesh(1, devices=CPU8),
                 make_mesh(8, axis_names=("data", "hyp"), devices=CPU8)):
        step = multichip.build_update_step(mesh, w, h, hypotheses=16,
                                           ba_capacity=16, max_keypoints=120,
                                           camera=world.camera)
        outs.append(step(images, sampler=jax_sampler(ke, ks)))
    one, sharded = outs
    for name in ("keypoints", "descriptors", "essential_inliers",
                 "sim3_inliers"):
        assert torch.equal(getattr(one, name), getattr(sharded, name)), name
    for name in ("poses", "points", "ba_cost"):
        np.testing.assert_allclose(getattr(sharded, name).numpy(),
                                   getattr(one, name).numpy(), rtol=1e-5,
                                   atol=1e-5)
