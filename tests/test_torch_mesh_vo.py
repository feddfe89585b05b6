"""``BatchedDeviceVO(mesh=)`` in the port: S sequences split over a mesh
of eight CPU devices equal the one-device run (the reference's
``TestMeshShardedVO`` and ``TestMeshShardedWindowBA``,
tests/test_device_vo.py:50-86, :134-170: poses within 1e-5, and 1e-4 /
1e-5 with the window BA; ``n_matched`` equal), the state reads back as one
``VOState``, and a checkpoint round-trips through a sharded session."""
import numpy as np
import pytest
import torch

from slam_tpu_torch.parallel.mesh import make_mesh
from slam_tpu_torch.pipeline.device_vo import (BatchedDeviceVO,
                                               DeviceVOConfig, VOState)
from slam_tpu_torch.utils.synthetic import default_camera

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


def _inputs(S, T, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (S, T, 120, 160)).astype(np.uint8)
    deltas = np.broadcast_to(np.eye(4, dtype=np.float32),
                             (S, T, 4, 4)).copy()
    return images, deltas


def test_sharded_matches_unsharded(tmp_path):
    cam = default_camera(160, 120)
    cfg = DeviceVOConfig(width=160, height=120, lm_capacity=32,
                         max_keypoints=60, ba_iterations=2,
                         window=0)   # pose-only scan variant
    S, T = 8, 3
    images, deltas = _inputs(S, T, 3)
    plain = BatchedDeviceVO(cfg, batch=S, camera=cam, device="cpu")
    out_plain = plain.advance(images, deltas)

    mesh = make_mesh(8, axis_names=("data",), devices=CPU8)
    sharded = BatchedDeviceVO(cfg, batch=S, camera=cam, mesh=mesh)
    assert len(sharded.shard_devices) == 8 and len(sharded._shards) == 8
    assert sharded._shards[0].pose_cw.shape[0] == 1
    out_sharded = sharded.advance(images, deltas)
    np.testing.assert_allclose(out_sharded.pose_cw.numpy(),
                               out_plain.pose_cw.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(out_sharded.n_matched, out_plain.n_matched)

    # the state reads back as one VOState of the whole batch
    state = sharded.state
    assert isinstance(state, VOState) and state.pose_cw.shape[0] == S
    for a, b in zip(state, plain.state):
        assert a.shape == b.shape and a.dtype == b.dtype
    # and a checkpoint of the sharded session resumes in a plain one
    path = str(tmp_path / "vo.npz")
    sharded.save_state(path)
    resumed = BatchedDeviceVO(cfg, batch=S, camera=cam, device="cpu")
    resumed.load_state(path)
    for a, b in zip(resumed.state, sharded.state):
        assert torch.equal(a, b)
    # setting the state splits it over the shards again
    sharded.state = resumed.state
    assert all(torch.equal(a, b) for a, b in zip(sharded.state,
                                                 resumed.state))


def test_batch_must_divide_by_the_data_axis():
    mesh = make_mesh(8, devices=CPU8)
    cfg = DeviceVOConfig(width=160, height=120, lm_capacity=32,
                         max_keypoints=60, window=0)
    with pytest.raises(AssertionError, match="not divisible"):
        BatchedDeviceVO(cfg, batch=6, camera=default_camera(160, 120),
                        mesh=mesh)


@pytest.mark.slow
def test_sharded_window_ba_matches_unsharded():
    cam = default_camera(160, 120)
    cfg = DeviceVOConfig(width=160, height=120, lm_capacity=32,
                         max_keypoints=60, ba_iterations=2,
                         window=4, window_ba_every=2, window_ba_iters=2)
    S, T = 8, 4
    images, deltas = _inputs(S, T, 11)
    plain = BatchedDeviceVO(cfg, batch=S, camera=cam, device="cpu")
    out_plain = plain.advance(images, deltas)
    mesh = make_mesh(8, axis_names=("data",), devices=CPU8)
    sharded = BatchedDeviceVO(cfg, batch=S, camera=cam, mesh=mesh)
    out_sharded = sharded.advance(images, deltas)
    np.testing.assert_allclose(out_sharded.pose_cw.numpy(),
                               out_plain.pose_cw.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sharded.state.win_pose_cw.numpy(),
                               plain.state.win_pose_cw.numpy(), rtol=1e-4,
                               atol=1e-5)
