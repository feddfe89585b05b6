"""Parity of the port's loop-closure device stages with the JAX package on
CPU: the batched Horn solvers, Sim3 RANSAC (with the JAX hypothesis bank
injected, since ``jax.random`` streams cannot be reproduced: same count
and inliers, R/t/s within 1e-5), the device Sim3 LM (R/t/s within 1e-5)
and the matcher's distance matrix (exact integers, both sides of its size
threshold)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.geometry import camera as jcamera
from slam_tpu.geometry import se3 as jse3
from slam_tpu.ops import ransac as jransac
from slam_tpu.ops import sim3_opt as jsim3
from slam_tpu_torch.geometry import camera as tcamera
from slam_tpu_torch.ops import ransac as transac
from slam_tpu_torch.ops import sim3_opt as tsim3

torch.set_num_threads(1)
TOL = 1e-5


def _problem(seed, n, outliers=0.25, scale=1.3):
    """Matched camera-frame points of a Sim3 pair: p2 = s R p1 + t, with
    pixel-scale noise and a share of outliers."""
    rng = np.random.default_rng(seed)
    R = jse3.so3_exp(rng.normal(0, 0.2, 3))
    t = rng.normal(0, 0.3, 3)
    pts1 = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3))
    pts2 = scale * pts1 @ R.T + t
    pts2 += rng.normal(0, 2e-3, pts2.shape)
    bad = rng.random(n) < outliers
    pts2[bad] += rng.normal(0, 0.5, (bad.sum(), 3))
    sig1 = rng.choice([1.0, 1.44, 2.07], n)
    sig2 = rng.choice([1.0, 1.44, 2.07], n)
    return pts1, pts2, sig1, sig2, (R, t, scale)


def _jax_bank(valid, iterations, seed):
    """The hypothesis bank of the JAX package's ``_sim3_ransac_impl``."""
    keys = jax.random.split(jax.random.PRNGKey(np.uint32(seed)), iterations)
    p = jnp.asarray(valid, jnp.float32)
    n = len(valid)
    pick = lambda k: jax.random.choice(k, n, shape=(3,), replace=False,
                                       p=p / jnp.sum(p))
    return np.asarray(jax.vmap(pick)(keys))


@pytest.mark.parametrize("solver", ["compute_sim3", "compute_rot_z"])
def test_horn_solvers_match_jax(solver):
    rng = np.random.default_rng(1)
    s1 = rng.normal(0, 1, (64, 3, 3)).astype(np.float32)
    s2 = rng.normal(0, 1, (64, 3, 3)).astype(np.float32)
    R, t, s = getattr(transac, solver)(torch.from_numpy(s1),
                                       torch.from_numpy(s2))
    jR, jt, js = (np.asarray(x) for x in jax.vmap(
        getattr(jransac, solver))(s1, s2))
    # rotations, not quaternions: the eigenvector's sign is free
    np.testing.assert_allclose(R.numpy(), jR, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), jt, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,dof,fix_scale",
                         [(150, "SIM3", False), (70, "SIM3", True),
                          (150, "ZROT", False)])
def test_sim3_ransac_matches_jax_with_the_jax_bank(n, dof, fix_scale,
                                                   monkeypatch):
    pts1, pts2, sig1, sig2, _ = _problem(n, n,
                                         scale=1.0 if fix_scale else 1.3)
    jcam = jcamera.default_camera(640, 480)
    tcam = tcamera.default_camera(640, 480)
    seed, iters = 94235682, 200
    want = jransac.Sim3Ransac(jcam, jcam, pts1, pts2, sig1, sig2).solve(
        iters, dof=dof, fix_scale=fix_scale, min_inliers=20, seed=seed)
    ransac = transac.Sim3Ransac(tcam, tcam, pts1, pts2, sig1, sig2,
                                device="cpu")
    assert len(ransac.valid) == max(64, -(-n // 64) * 64)   # 64-bucket
    bank = _jax_bank(ransac.valid, iters, seed)
    monkeypatch.setattr(transac, "sample_hypotheses",
                        lambda valid, k, s: torch.from_numpy(
                            bank.astype(np.int64)))
    got = ransac.solve(iters, dof=dof, fix_scale=fix_scale, min_inliers=20,
                       seed=seed)
    assert got.num_inliers == want.num_inliers
    assert got.ok == want.ok
    np.testing.assert_array_equal(got.inliers, want.inliers)
    np.testing.assert_allclose(got.rot_12, want.rot_12, atol=TOL)
    np.testing.assert_allclose(got.trans_12, want.trans_12, atol=TOL)
    assert abs(got.scale_12 - want.scale_12) < TOL
    if dof == "SIM3":
        assert want.ok and want.num_inliers > 0.6 * n


def test_own_sampler_draws_distinct_valid_triples_per_seed():
    valid = torch.arange(128) < 70
    a = transac.sample_hypotheses(valid, 300, 5)
    b = transac.sample_hypotheses(valid, 300, 5)
    assert a.shape == (300, 3) and torch.equal(a, b)
    assert not torch.equal(a, transac.sample_hypotheses(valid, 300, 6))
    assert bool((a < 70).all())
    s = torch.sort(a, dim=1).values
    assert bool((s[:, 1:] != s[:, :-1]).all())
    # and the RANSAC it feeds finds the transform
    pts1, pts2, sig1, sig2, (R, t, scale) = _problem(150, 150)
    cam = tcamera.default_camera(640, 480)
    res = transac.Sim3Ransac(cam, cam, pts1, pts2, sig1, sig2,
                             device="cpu").solve(200, seed=5)
    assert res.ok
    np.testing.assert_allclose(1.0 / res.scale_12, scale, rtol=5e-3)
    np.testing.assert_allclose(res.rot_12.T, R, atol=5e-3)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_transform_matches_jax(fix_scale):
    rng = np.random.default_rng(7)
    n = 90
    # cam2 -> cam1 similarity (R, t, s): p1 = s R p2 + t
    R = jse3.so3_exp(rng.normal(0, 0.15, 3))
    t = rng.normal(0, 0.2, 3)
    s = 1.0 if fix_scale else 0.8
    pts2 = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3))
    pts1 = s * pts2 @ R.T + t + rng.normal(0, 3e-3, (n, 3))
    obs1 = pts1[:, :2] / pts1[:, 2:] + rng.normal(0, 1e-3, (n, 2))
    obs2 = pts2[:, :2] / pts2[:, 2:] + rng.normal(0, 1e-3, (n, 2))
    obs1[:5] += 0.05                                 # Huber-weighted rows
    sig1 = rng.choice([1.0, 1.44], n)
    sig2 = rng.choice([1.0, 1.44], n)
    R0 = jse3.so3_exp(rng.normal(0, 0.02, 3)) @ R
    t0 = t + rng.normal(0, 0.02, 3)
    s0 = s * (1.0 if fix_scale else 1.03)
    args = (R0, t0, s0, pts1, pts2, obs1, obs2, sig1, sig2, 5.991, fix_scale)
    jR, jt, js = jsim3.optimize_sim3_transform(*args)
    tR, tt, ts = tsim3.optimize_sim3_transform(*args, device="cpu")
    np.testing.assert_allclose(tR, jR, atol=TOL)
    np.testing.assert_allclose(tt, jt, atol=TOL)
    assert abs(ts - js) < TOL
    assert np.abs(jR - R0).max() > 1e-3              # the LM moved
    if fix_scale:
        assert ts == s0


@pytest.mark.parametrize("n,m", [(300, 400), (2100, 2100)],
                         ids=["host", "device"])
def test_distance_matrix_equal(n, m):
    jmatcher = importlib.import_module("slam_tpu.pipeline.matcher")
    from slam_tpu_torch.pipeline import matcher as tmatcher

    rng = np.random.default_rng(n)
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    got = tmatcher._distance_matrix(a, b, "cpu")
    assert got.shape == (n, m) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jmatcher._distance_matrix(a, b))
