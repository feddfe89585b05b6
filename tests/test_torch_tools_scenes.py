"""The rendered-sequence tools' scene code in the port (``tools/torch_*``)
against the originals (``tools/run_euroc_synthetic.py``,
``tools/run_kitti_synthetic.py``, ``tools/run_device_vo_euroc.py``,
``tools/eval_vocab_transfer.py``, ``bench.render_world``): textures, planes,
trajectories and rendered frames bit-equal, ATE equal to 1e-12, the drift
draws equal."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

import eval_vocab_transfer as jvocab  # noqa: E402
import run_euroc_synthetic as jeuroc  # noqa: E402
import run_kitti_synthetic as jkitti  # noqa: E402
import torch_eval_vocab_transfer as tvocab  # noqa: E402
import torch_run_device_vo_euroc as tdvo  # noqa: E402
import torch_run_euroc_synthetic as teuroc  # noqa: E402
import torch_run_kitti_synthetic as tkitti  # noqa: E402


def _same_scene(a, b):
    (ta, pa), (tb, pb) = a, b
    assert pa == pb
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed,tile", [(0, 0), (1, 0), (0, 8), (1, 8)])
def test_room_scene_and_frames_bit_equal(seed, tile):
    a, b = jeuroc.make_scene(seed, tile=tile), teuroc.make_scene(seed,
                                                                 tile=tile)
    _same_scene(a, b)
    _, poses = teuroc.make_sequence(24, seed)
    for i in (0, 11, 23):
        img = teuroc.render(b, poses[i])
        assert img.shape == (480, 752) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, jeuroc.render(a, poses[i]))
    assert img.std() > 20                     # textured, not blank


def test_street_scene_and_frames_bit_equal():
    a = jkitti.make_street_scene(0)
    b = tkitti.make_street_scene(0)
    _same_scene(a, b)
    _, pa = jkitti.make_sequence(12)
    _, pb = tkitti.make_sequence(12)
    np.testing.assert_array_equal(pa, pb)
    for i in (0, 7):
        img = teuroc.render(b, pb[i], cam=tkitti.CAM)
        assert img.shape == (376, 1241)       # the odd KITTI width
        np.testing.assert_array_equal(
            img, jeuroc.render(a, pa[i], cam=jkitti.CAM))
    # the scaled small circuit of the diagnostic run
    f = 30.0 / tkitti.RADIUS
    _same_scene(jkitti.make_street_scene(0, outer=jkitti.OUTER * f,
                                         inner=jkitti.INNER * f),
                tkitti.make_street_scene(0, outer=tkitti.OUTER * f,
                                         inner=tkitti.INNER * f))


def test_cameras_and_constants_equal():
    for j, t in ((jeuroc.CAM, teuroc.CAM), (jkitti.CAM, tkitti.CAM)):
        assert (j.fx, j.fy, j.cx, j.cy, j.width, j.height) == \
            (t.fx, t.fy, t.cx, t.cy, t.width, t.height)
    assert (jkitti.FPS, jkitti.SPEED, jkitti.RADIUS, jkitti.OUTER,
            jkitti.INNER, jkitti.WALL_H, jkitti.TEX_SIZE) == \
        (tkitti.FPS, tkitti.SPEED, tkitti.RADIUS, tkitti.OUTER, tkitti.INNER,
         tkitti.WALL_H, tkitti.TEX_SIZE)
    assert (jeuroc.ROOM, jeuroc.TEX_SIZE) == (teuroc.ROOM, teuroc.TEX_SIZE)
    assert jvocab.LEVELS == tvocab.LEVELS


@pytest.mark.parametrize("n,seed", [(1, 0), (240, 0), (97, 3)])
def test_sequences_and_circle_poses_equal(n, seed):
    tj, pj = jeuroc.make_sequence(n, seed)
    tt, pt = teuroc.make_sequence(n, seed)
    np.testing.assert_array_equal(tj, tt)
    np.testing.assert_array_equal(pj, pt)
    for phase, radius, y in ((0.0, 3.2, 0.0), (1.3, 30.0, 0.5),
                             (-2.0, 80.0, -1.0)):
        np.testing.assert_array_equal(jeuroc.circle_pose_cw(phase, radius, y),
                                      teuroc.circle_pose_cw(phase, radius, y))
    tj, pj = jkitti.make_sequence(n, radius=30.0)
    tt, pt = tkitti.make_sequence(n, radius=30.0)
    np.testing.assert_array_equal(tj, tt)
    np.testing.assert_array_equal(pj, pt)


def test_ate_rmse_equal():
    rng = np.random.default_rng(5)
    gt = {float(t): rng.normal(size=3) for t in np.arange(40) / 20.0}
    rows = np.concatenate([np.sort(rng.uniform(0, 2, (25, 1)), axis=0),
                           rng.normal(size=(25, 3))], axis=1)
    a, b = jeuroc.ate_rmse(rows, gt), teuroc.ate_rmse(rows, gt)
    assert a > 0.1
    assert abs(a - b) <= 1e-12


def test_drift_draws_equal():
    """The device-VO twin's odometry (random walk from ``seed + 7``) equals
    the original's inline construction (run_device_vo_euroc.py:62-70); the
    KITTI twin's drifted pose equals the original's (run_kitti_synthetic.py
    :172-184)."""
    from slam_tpu.geometry import se3 as jse3

    _, poses = jeuroc.make_sequence(30, 2)
    odo, deltas = tdvo.drifted_odometry(poses, 0.008, 2)
    rng = np.random.default_rng(2 + 7)
    drift_rw = np.zeros(3)
    want = []
    for i in range(30):
        drift_rw += rng.normal(0.0, 0.008, 3)
        want.append(jse3.se3_exp(np.concatenate([np.zeros(3), drift_rw]))
                    @ poses[i])
    want = np.stack(want)
    np.testing.assert_array_equal(odo, want)
    np.testing.assert_array_equal(deltas[0], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(
        deltas[5], (want[5] @ np.linalg.inv(want[4])).astype(np.float32))

    _, kposes = jkitti.make_sequence(20)
    rng = np.random.default_rng(7)
    drift_rw = np.zeros(3)
    for i in range(20):
        drift_rw += rng.normal(0.0, 0.01, 3)
        ang = 1.2e-4 * i
        c, s = np.cos(ang), np.sin(ang)
        yaw_inv = np.eye(4)
        yaw_inv[0, 0] = yaw_inv[2, 2] = c
        yaw_inv[0, 2] = -s
        yaw_inv[2, 0] = s
        want = jse3.se3_exp(np.concatenate([np.zeros(3), drift_rw])) \
            @ kposes[i] @ yaw_inv
        np.testing.assert_array_equal(
            tkitti.drifted_pose_cw(kposes[i], drift_rw, 1.2e-4, i), want)


def test_profile_world_equals_bench():
    import bench
    import torch_profile_pipeline as tprof

    wj, pj = bench.render_world(n_frames=6)
    wt, pt = tprof.render_world(n_frames=6)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(wj.landmarks, wt.landmarks)
    for i in range(6):
        np.testing.assert_array_equal(wj.poses_cw[i], wt.poses_cw[i])
        np.testing.assert_array_equal(wj.odometry_cw[i], wt.odometry_cw[i])
        assert wj.times[i] == wt.times[i]
        from slam_tpu_torch.utils.synthetic import render_frame
        np.testing.assert_array_equal(bench.render_frame(wj, pj, i),
                                      render_frame(wt, pt, i))


def test_vocab_perturbations_and_domains_equal():
    rng = np.random.default_rng(0)
    pose = teuroc.circle_pose_cw(0.7)
    for dx, dyaw in ((0.0, 0.0), (0.25, 10.0), (0.5, -20.0)):
        np.testing.assert_array_equal(jvocab._perturb_pose(pose, dx, dyaw),
                                      tvocab._perturb_pose(pose, dx, dyaw))
    img = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    for lvl in jvocab.LEVELS:
        _, _, _, gain, bias, sigma = lvl
        a = jvocab._photometric(img, gain, bias, sigma,
                                np.random.default_rng(3))
        b = tvocab._photometric(img, gain, bias, sigma,
                                np.random.default_rng(3))
        np.testing.assert_array_equal(a, b)
    # the dot domain's frames and perturbed queries
    ij, qj, wj, hj = jvocab._dots_domain(4, 100)
    it, qt, wt, ht = tvocab._dots_domain(4, 100)
    assert (wj, hj) == (wt, ht)
    for a, b in zip(ij, it):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(qj(1, 0.25, 10.0), qt(1, 0.25, 10.0))
