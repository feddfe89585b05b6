"""The port keeps its own copies of what it needs from the JAX package's
JAX-free modules, and they equal their originals: the ORB pattern and patch
radius, the static settings (per-level sigma^2 included), the default
camera, the NumPy SE(3)/Sim(3) maps, the host Hamming matrix and the trained
vocabulary file. Its entry points default to the CUDA card."""
import dataclasses
import hashlib
import inspect
import os

import numpy as np
import pytest
import torch

from slam_tpu import params as jparams
from slam_tpu.geometry import camera as jcamera
from slam_tpu.geometry import se3 as jse3
from slam_tpu.native import hamming_matrix as jhamming_native
from slam_tpu.ops import orb_pattern as jpattern
from slam_tpu_torch import DeviceSlam
from slam_tpu_torch import params as tparams
from slam_tpu_torch.geometry import camera as tcamera
from slam_tpu_torch.geometry import se3 as tse3
from slam_tpu_torch.ops import orb_pattern as tpattern
from slam_tpu_torch.ops.bow import BowIndex
from slam_tpu_torch.ops.frontend import OrbExtractor
from slam_tpu_torch.ops.hamming import hamming_matrix_host
from slam_tpu_torch.ops.ransac import Sim3Ransac
from slam_tpu_torch.pipeline import device_vo as tvo
from slam_tpu_torch.pipeline.bundle_adjustment import WorkspaceBA
from slam_tpu_torch.pipeline.loop_closer import LoopCloser
from slam_tpu_torch.pipeline.mapper import Mapper
from slam_tpu_torch.pipeline.slam_api import Slam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_orb_pattern_and_patch_radius_equal_the_originals():
    np.testing.assert_array_equal(tpattern.ORB_PATTERN, jpattern.ORB_PATTERN)
    assert tpattern.ORB_PATTERN.dtype == jpattern.ORB_PATTERN.dtype
    assert tparams.ORB_PATCH_RADIUS == jparams.ORB_PATCH_RADIUS


@pytest.mark.parametrize("overrides", [{}, {"maxKeypoints": 600},
                                       {"orbScaleLevels": 4,
                                        "orbScaleFactor": 1.5}],
                         ids=["default", "600_keypoints", "4_levels"])
def test_static_settings_equal_the_originals(overrides):
    j = jparams.StaticSettings(jparams.Parameters(
        slam=jparams.ParametersSlam(**overrides)))
    t = tparams.StaticSettings(tparams.Parameters(
        slam=tparams.ParametersSlam(**overrides)))
    assert t.maxNumberOfKeypointsPerLevel() == j.maxNumberOfKeypointsPerLevel()
    np.testing.assert_array_equal(t.scaleFactors, j.scaleFactors)
    np.testing.assert_array_equal(t.levelSigmaSq, j.levelSigmaSq)
    assert t.levelSigmaSq.dtype == j.levelSigmaSq.dtype
    assert (dataclasses.asdict(t.parameters.slam)
            == dataclasses.asdict(j.parameters.slam))


@pytest.mark.parametrize("size", [(752, 480), (640, 480)])
def test_default_camera_equals_the_original(size):
    t, j = tcamera.default_camera(*size), jcamera.default_camera(*size)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    pts = np.random.default_rng(0).uniform([-2, -2, 1], [2, 2, 6], (64, 3))
    for a, b in zip(t.ray_to_pixel(pts), j.ray_to_pixel(pts)):
        np.testing.assert_array_equal(a, b)


def test_pinhole_projection_equals_the_original():
    """The kept host methods of the trimmed copy, with distortion on."""
    fields = dict(fx=420.0, fy=410.0, cx=322.0, cy=241.0, width=640,
                  height=480, k1=-0.05, k2=0.01, p1=1e-3, p2=-5e-4)
    t, j = tcamera.PinholeCamera(**fields), jcamera.PinholeCamera(**fields)
    pts = np.random.default_rng(2).uniform([-3, -3, -1], [3, 3, 8], (256, 3))
    (tp, tok), (jp, jok) = t.ray_to_pixel(pts), j.ray_to_pixel(pts)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(t.is_valid_pixel(tp, margin=8),
                                  j.is_valid_pixel(jp, margin=8))
    assert 0 < t.is_valid_pixel(tp, margin=8).sum() < len(pts)


def test_se3_maps_equal_the_originals():
    rng = np.random.default_rng(1)
    xi = rng.normal(0, 0.7, (32, 6))
    xi[:4, :3] = 0.0                     # the small-angle branches
    xi[4:8, :3] *= 1e-13
    for x in xi:
        np.testing.assert_array_equal(tse3.so3_exp(x[:3]), jse3.so3_exp(x[:3]))
        np.testing.assert_array_equal(tse3.se3_exp(x), jse3.se3_exp(x))


def test_sim3_maps_equal_the_originals():
    rng = np.random.default_rng(3)
    for _ in range(8):
        T = jse3.se3_exp(rng.normal(0, 0.6, 6))
        np.testing.assert_array_equal(tse3.camera_center(T),
                                      jse3.camera_center(T))
        np.testing.assert_array_equal(tse3.so3_log(T[:3, :3]),
                                      jse3.so3_log(T[:3, :3]))
        np.testing.assert_array_equal(tse3.rmat_to_quat(T[:3, :3]),
                                      jse3.rmat_to_quat(T[:3, :3]))
        j, t = jse3.Sim3.from_se3(T), tse3.Sim3.from_se3(T)
        for lam in (0.0, 0.3, 1.0):
            a = jse3.interpolate_sim3(jse3.Sim3.identity(), j, lam)
            b = tse3.interpolate_sim3(tse3.Sim3.identity(), t, lam)
            np.testing.assert_array_equal(b.to_se3(), a.to_se3())
        np.testing.assert_array_equal((t.inverse() * t).to_se3(),
                                      (j.inverse() * j).to_se3())


def test_host_hamming_matrix_equals_the_native_one():
    """The port's NumPy matrix against what the JAX package's closure
    consumer calls (native popcount, or its NumPy fallback)."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2 ** 32, (130, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (97, 8), dtype=np.uint32)
    np.testing.assert_array_equal(hamming_matrix_host(a, b),
                                  jhamming_native(a, b))


def test_vocabulary_file_is_a_byte_copy():
    def sha(path):
        with open(os.path.join(ROOT, path), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert (sha("slam_tpu_torch/data/vocab_65536.npz")
            == sha("slam_tpu/data/vocab_65536.npz"))


@pytest.mark.parametrize("fn", [tvo.make_vo_step, tvo.init_state,
                                tvo.state_from_numpy, tvo.BatchedDeviceVO,
                                DeviceSlam, Slam, Slam.build, Mapper,
                                OrbExtractor, BowIndex, LoopCloser,
                                Sim3Ransac],
                         ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_bundle_adjustment_workspace_defaults_to_the_card():
    assert WorkspaceBA().device == torch.device("cuda")


def test_default_device_is_the_card():
    """A default call lands on the card; without one it raises from torch
    (no CPU fallback)."""
    cfg = tvo.DeviceVOConfig(width=160, height=120, lm_capacity=64,
                             max_keypoints=80, window=2, window_ba_every=2,
                             loop_every=1, loop_points=32, loop_words=64)
    if torch.cuda.is_available():
        assert tvo.init_state(cfg, 10).pose_cw.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tvo.init_state(cfg, 10)
