"""The KITTI-class street's scale drift is in the local BA's cost, and both
packages share it: for the odometry that the street tool feeds, the cost's
minimum is a shortened window.

``tests/data/street_local_ba_50.npz`` is keyframe 50's two-stage local BA
on the 620-frame street at seed 0 (``python3 tools/trace_euroc_ba.py
--scene street --no-reloc --replay-kf 50 --save ...``, the port on an
NVIDIA H100): the padded problem, its stage-2 arguments and the true poses
of the window's keyframes (frames 30-50). Started at the truth (the true
poses, every point triangulated through them by
``trace_euroc_ba.triangulate_at``), the JAX package's and the port's
``solve_ba_two_stage`` (both in f64) take the same step: the window comes
out about 1.7 % short (Sim3-fit scale 0.983), as the drift the street
shows from frame 40. With the odometry edges' measurements set to the true
relative poses both stay at the truth, and with only their sideways (camera
x) parts kept the shortening comes back: the tool's odometry error, a
random walk added in each camera's own frame, turns with the camera into a
sideways error of a few mm a step, and the solve answers +5 mm a step by
shortening the window and -5 mm by lengthening it."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tools_shared  # noqa: F401  (puts tools/ on the path)
import trace_euroc_ba as tracer
from slam_tpu.ops import ba as jba
from slam_tpu_torch.ops import ba

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "street_local_ba_50.npz")
FIELDS = ba.BAProblem._fields


@pytest.fixture(scope="module")
def capture():
    """The captured problem in f64 and the same problem started at the
    truth."""
    z = np.load(DATA)
    p = {f: (z[f].astype(np.float64) if z[f].dtype == np.float32 else z[f])
         for f in FIELDS}
    truth = z["truth"]
    nk = len(truth)
    poses = np.concatenate([truth, p["poses"][nk:]])
    X, ok = tracer.triangulate_at(
        poses, p["points"], p["obs_kf"], p["obs_mp"], p["obs_meas"],
        p["obs_sqrt_info"], p["obs_valid"])
    ok &= ~p["points_fixed"]
    start = dict(p, poses=poses, points=np.where(ok[:, None], X, p["points"]),
                 points_fixed=p["points_fixed"] | ~ok,
                 obs_valid=p["obs_valid"] & ok[p["obs_mp"]])
    exact = p["pe_meas"].copy()
    for e in np.flatnonzero(p["pe_valid"]):
        exact[e] = poses[p["pe_b"][e]] @ np.linalg.inv(poses[p["pe_a"][e]])
    return dict(z=z, p=p, start=start, exact=exact, nk=nk, ok=ok)


def _centres(poses):
    return np.array([-T[:3, :3].T @ T[:3, 3] for T in poses])


def _solve(package, prob, z):
    """Both stages of the local BA on ``prob`` (a dict of f64 arrays) with
    the captured stage-2 arguments; the solved poses."""
    kw = dict(iterations=int(z["iterations"]), cg_iters=int(z["cg_iters"]))
    if package == "jax":
        with jax.enable_x64(True):
            res = jba.solve_ba_two_stage(
                jba.BAProblem(**{f: jnp.asarray(prob[f]) for f in FIELDS}),
                jnp.asarray(z["stage2_pose_fixed"]),
                jnp.asarray(int(z["anchor_slot"]), jnp.int32),
                jnp.asarray(z["anchor_sqrt_info"].astype(np.float64)), **kw)
            return np.asarray(res.poses, np.float64)
    res = ba.solve_ba_two_stage(
        ba.BAProblem(**{f: torch.from_numpy(np.ascontiguousarray(
            prob[f]))[None] for f in FIELDS}),
        torch.from_numpy(z["stage2_pose_fixed"])[None],
        torch.tensor([int(z["anchor_slot"])]),
        torch.from_numpy(z["anchor_sqrt_info"].astype(np.float64))[None],
        **kw)
    return res.poses[0].numpy()


def _scale(capture, poses):
    nk = capture["nk"]
    return tracer.sim3_scale(_centres(poses[:nk]),
                             _centres(capture["z"]["truth"]))


@pytest.fixture(scope="module")
def from_truth(capture):
    return {package: _solve(package, capture["start"], capture["z"])
            for package in ("jax", "torch")}


def test_capture_is_a_street_window(capture):
    z = capture["z"]
    assert list(z["frames"]) == list(range(30, 51))
    assert int(z["anchor_slot"]) == 20
    assert not z["stage2_pose_fixed"][:21].any()
    # almost every window point has two observations or more
    assert capture["ok"].sum() >= 0.9 * (~capture["p"]["points_fixed"]).sum()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_local_ba_from_the_truth_shortens_the_window(capture, from_truth,
                                                      package):
    assert 0.975 < _scale(capture, from_truth[package]) < 0.99


def test_both_packages_take_the_same_step(capture, from_truth):
    nk = capture["nk"]
    jc = _centres(from_truth["jax"][:nk])
    tc = _centres(from_truth["torch"][:nk])
    moved = np.linalg.norm(tc - _centres(capture["z"]["truth"]), axis=1)
    assert moved.max() > 0.2
    np.testing.assert_allclose(tc, jc, atol=1e-6)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_odometry_at_the_truth_keeps_the_scale(capture, package):
    prob = dict(capture["start"], pe_meas=capture["exact"])
    assert abs(_scale(capture, _solve(package, prob, capture["z"])) - 1) \
        < 2e-3


def _sideways(capture, x):
    """The true odometry edges with the sideways (camera x) part of their
    translation measured (``x`` None) or shifted by ``x`` metres a step."""
    m = capture["exact"].copy()
    m[:, 0, 3] = capture["p"]["pe_meas"][:, 0, 3] if x is None \
        else m[:, 0, 3] + x
    return dict(capture["start"], pe_meas=m)


def test_the_measured_sideways_part_alone_shortens_the_window(capture):
    valid = capture["p"]["pe_valid"]
    side = (capture["p"]["pe_meas"] - capture["exact"])[valid, 0, 3]
    assert side.mean() > 0.004            # +5.3 mm a step on this window
    poses = _solve("torch", _sideways(capture, None), capture["z"])
    assert _scale(capture, poses) < 0.99


@pytest.mark.parametrize("x, shorter", [(0.005, True), (-0.005, False)],
                         ids=["plus_5mm", "minus_5mm"])
def test_sideways_odometry_error_sets_the_scale(capture, x, shorter):
    scale = _scale(capture, _solve("torch", _sideways(capture, x),
                                   capture["z"]))
    assert (scale < 0.99) if shorter else (scale > 1.01), scale
