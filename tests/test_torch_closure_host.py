"""Parity of the port's host closure stack with the JAX package's originals:
the NumPy Sim3 RANSAC and refinement, the drift-angle gate, the Sim3
algebra and interpolation, the retrieval-score gate, the Lowe mutual-NN
matcher, the host Hamming matrix and the per-level sigma^2. Both sides are
NumPy over the same seeded inputs, so integer results must be equal and
float results agree to 1e-9 (the same float64 operations in the same
order; the bound leaves room for BLAS blocking)."""
import numpy as np
import pytest
import torch

from slam_tpu import params as jparams
from slam_tpu.geometry import camera as jcamera
from slam_tpu.geometry import se3 as jse3
from slam_tpu.ops import hamming as jhamming
from slam_tpu.ops import ransac as jransac
from slam_tpu.ops import sim3_opt as jsim3
from slam_tpu.pipeline import device_slam as jslam
from slam_tpu.pipeline import loop_closer as jloop
from slam_tpu_torch import params as tparams
from slam_tpu_torch.geometry import camera as tcamera
from slam_tpu_torch.geometry import se3 as tse3
from slam_tpu_torch.ops import hamming as thamming
from slam_tpu_torch.ops import ransac as transac
from slam_tpu_torch.ops import sim3_opt as tsim3
from slam_tpu_torch.pipeline import device_slam as tslam
from slam_tpu_torch.pipeline import loop_closer as tloop

torch.set_num_threads(1)
TOL = 1e-9


def _cameras():
    return jcamera.default_camera(640, 480), tcamera.default_camera(640, 480)


def _correspondences(seed, n=60, outliers=12, scale=1.0, planar=False):
    """Camera-frame point pairs pts1 = s R pts2 + t (+ outliers and pixel
    noise) and per-match levelSigmaSq from random octaves."""
    rng = np.random.default_rng(seed)
    pts2 = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 7.0], (n, 3))
    omega = [0.0, 0.0, 0.3] if planar else [0.04, 0.4, -0.03]
    R = jse3.so3_exp(np.array(omega))
    t = np.array([0.3, -0.15, 0.4])
    pts1 = scale * pts2 @ R.T + t + rng.normal(0, 2e-3, (n, 3))
    pts1[:outliers] += rng.uniform(0.5, 1.5, (outliers, 3))
    lv = jparams.calc_level_sigma_sq(8, 1.2)
    return (pts1.astype(np.float32), pts2.astype(np.float32),
            lv[rng.integers(0, 8, n)], lv[rng.integers(0, 8, n)])


@pytest.mark.parametrize("dof", ["SIM3", "ZROT"])
@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_host_equals_the_original(dof, fix_scale):
    jcam, tcam = _cameras()
    pts1, pts2, sig1, sig2 = _correspondences(
        seed=3, scale=1.0 if fix_scale else 1.15, planar=dof == "ZROT")
    args = (pts1, pts2, sig1, sig2, 200)
    kw = dict(dof=dof, fix_scale=fix_scale, min_inliers=20)
    j = jransac.sim3_ransac_host(jcam, jcam, *args, **kw)
    t = transac.sim3_ransac_host(tcam, tcam, *args, **kw)
    assert j.ok and t.ok and t.num_inliers == j.num_inliers >= 30
    np.testing.assert_array_equal(t.inliers, j.inliers)
    np.testing.assert_allclose(t.rot_12, j.rot_12, rtol=0, atol=TOL)
    np.testing.assert_allclose(t.trans_12, j.trans_12, rtol=0, atol=TOL)
    assert abs(t.scale_12 - j.scale_12) <= TOL
    assert transac.CHI_SQ_2D == jransac.Sim3Ransac.CHI_SQ_2D
    # too few matches: the same refusal
    few = transac.sim3_ransac_host(tcam, tcam, pts1[:5], pts2[:5], sig1[:5],
                                   sig2[:5], 50, min_inliers=20)
    assert not few.ok and few.num_inliers == 0


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_transform_host_equals_the_original(fix_scale):
    pts1, pts2, sig1, sig2 = _correspondences(seed=5, outliers=4,
                                              scale=1.0 if fix_scale else 1.2)
    obs1 = pts1[:, :2] / pts1[:, 2:3]
    obs2 = pts2[:, :2] / pts2[:, 2:3]
    R0 = jse3.so3_exp(np.array([0.06, 0.37, -0.01]))
    t0 = np.array([0.25, -0.1, 0.45])
    args = (R0, t0, 1.05, pts1, pts2, obs1, obs2, sig1, sig2, 10.0,
            fix_scale)
    Rj, tj, sj = jsim3.optimize_sim3_transform_host(*args)
    Rt, tt, st = tsim3.optimize_sim3_transform_host(*args)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=TOL)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=TOL)
    assert abs(st - sj) <= TOL
    assert np.abs(Rt - R0).max() > 1e-3          # the LM moved the estimate
    assert tsim3.optimize_sim3_transform_host(
        R0, t0, 1.0, pts1[:0], pts2[:0], obs1[:0], obs2[:0], sig1[:0],
        sig2[:0], 10.0, fix_scale)[2] == 1.0


def _rigid(rng, rot=0.4, trans=1.0):
    return jse3.se3_exp(np.concatenate([rng.normal(0, rot, 3),
                                        rng.normal(0, trans, 3)]))


def test_drift_gate_angle_equals_the_original():
    rng = np.random.default_rng(7)
    for _ in range(16):
        U, cand, curr = _rigid(rng), _rigid(rng), _rigid(rng)
        U[:3, :3] *= rng.uniform(0.8, 1.25)       # a Sim3 scale in U
        want = jloop.drift_gate_angle(U, cand, curr)
        assert abs(tloop.drift_gate_angle(U, cand, curr) - want) <= TOL
        np.testing.assert_allclose(tloop._closest_rotation(U[:3, :3]),
                                   jloop._closest_rotation(U[:3, :3]),
                                   rtol=0, atol=TOL)


def test_sim3_algebra_and_interpolation_equal_the_originals():
    rng = np.random.default_rng(8)
    for _ in range(8):
        A, B = _rigid(rng), _rigid(rng)
        s = rng.uniform(0.7, 1.4)
        ja = jse3.Sim3(A[:3, :3], A[:3, 3], s)
        ta = tse3.Sim3(A[:3, :3], A[:3, 3], s)
        jb, tb = jse3.Sim3.from_se3(B), tse3.Sim3.from_se3(B)
        p = rng.normal(0, 2, 3)
        for jx, tx in ((ja * jb, ta * tb), (ja.inverse(), ta.inverse()),
                       ((ja * jb).inverse() * ja, (ta * tb).inverse() * ta)):
            np.testing.assert_allclose(tx.R, jx.R, rtol=0, atol=TOL)
            np.testing.assert_allclose(tx.t, jx.t, rtol=0, atol=TOL)
            assert abs(tx.s - jx.s) <= TOL
            np.testing.assert_allclose(tx.map(p), jx.map(p), rtol=0, atol=TOL)
            np.testing.assert_allclose(tx.to_se3(), jx.to_se3(), rtol=0,
                                       atol=TOL)
        for lam in (0.0, 0.25, 0.5, 0.999, 1.0):
            ji = jse3.interpolate_sim3(jse3.Sim3.identity(), ja, lam)
            ti = tse3.interpolate_sim3(tse3.Sim3.identity(), ta, lam)
            np.testing.assert_allclose(ti.R, ji.R, rtol=0, atol=TOL)
            np.testing.assert_allclose(ti.t, ji.t, rtol=0, atol=TOL)
            assert abs(ti.s - ji.s) <= TOL
        np.testing.assert_array_equal(tse3.camera_center(A),
                                      jse3.camera_center(A))
    # the quaternion branches (trace <= 0 picks the largest diagonal)
    for omega in ([np.pi - 1e-3, 0, 0], [0, np.pi - 1e-3, 0],
                  [0, 0, np.pi - 1e-3], [1e-14, 0, 0], [0.3, -0.2, 0.1]):
        R = jse3.so3_exp(np.array(omega))
        np.testing.assert_array_equal(tse3.rmat_to_quat(R),
                                      jse3.rmat_to_quat(R))
        np.testing.assert_array_equal(tse3.so3_log(R), jse3.so3_log(R))
        q = jse3.rmat_to_quat(R)
        np.testing.assert_array_equal(tse3.quat_to_rmat(q),
                                      jse3.quat_to_rmat(q))
        np.testing.assert_array_equal(tse3.quat_slerp(q, -q[::-1], 0.3),
                                      jse3.quat_slerp(q, -q[::-1], 0.3))


def test_loop_gate_and_lowe_matcher_equal_the_originals():
    rng = np.random.default_rng(9)
    for scores in (rng.uniform(-1.0, 0.9, 40), np.full(5, -1.0),
                   rng.uniform(0.95, 1.0, 12)):
        assert (tslam.calibrate_loop_gate(scores, 0.02, 0.5)
                == jslam.calibrate_loop_gate(scores, 0.02, 0.5))
    d1 = rng.integers(0, 2 ** 32, (96, 8), dtype=np.uint32)
    d2 = d1[rng.permutation(96)].copy()
    d2[::3, 0] ^= np.uint32(0xFFFF)                # some rows far away
    d2[1::3, 1] ^= np.uint32(0x7)                  # some rows near
    dist = jhamming.hamming_matrix_host(d1, d2)
    v1, v2 = rng.random(96) < 0.9, rng.random(96) < 0.9
    for ratio in (0.9, 0.6, 1.0):
        for a, b in zip(tslam._mutual_nn_lowe(dist, v1, v2, ratio),
                        jslam._mutual_nn_lowe(dist, v1, v2, ratio)):
            np.testing.assert_array_equal(a, b)
    assert len(tslam._mutual_nn_lowe(dist, v1, v2, 0.9)[0]) > 20
    assert len(tslam._mutual_nn_lowe(dist[:, :1], v1, v2[:1], 0.9)[0]) == 0


def test_hamming_matrix_host_is_bit_equal():
    rng = np.random.default_rng(10)
    a = rng.integers(0, 2 ** 32, (70, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (45, 8), dtype=np.uint32)
    b[:10] = a[:10]
    got = thamming.hamming_matrix_host(a, b)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jhamming.hamming_matrix_host(a, b))
    assert (np.diag(got[:10, :10]) == 0).all()
    # non-contiguous rows, as a strided view of a mirror row hands them over
    np.testing.assert_array_equal(thamming.hamming_matrix_host(a[::2], b),
                                  jhamming.hamming_matrix_host(a[::2], b))


@pytest.mark.parametrize("levels,factor", [(8, 1.2), (4, 1.5), (1, 2.0)])
def test_level_sigma_sq_equals_the_original(levels, factor):
    t = tparams.calc_level_sigma_sq(levels, factor)
    j = jparams.calc_level_sigma_sq(levels, factor)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)
