"""The torch scene generators against the rendered-sequence tools' NumPy
ones, at a small size on the CPU. Measured agreement: frames bit-equal
(max difference 0 gray levels) on shared textures, trajectories and
odometry equal to the last bit."""
import os
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from harness import scenes

sys.path.insert(0, os.path.join(ROOT, "tools"))


@pytest.fixture(scope="module")
def tools():
    import torch_run_euroc_synthetic as room
    import torch_run_kitti_synthetic as street

    return room, street


def _cam(tool_cam, div):
    from slam_tpu_torch.geometry.camera import PinholeCamera

    return PinholeCamera(fx=tool_cam.fx / div, fy=tool_cam.fy / div,
                         cx=tool_cam.cx / div, cy=tool_cam.cy / div,
                         width=tool_cam.width // div,
                         height=tool_cam.height // div)


def _mine(cam):
    return scenes.Camera(dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                              width=cam.width, height=cam.height))


def test_room_frames_equal_the_tools(tools):
    room, _ = tools
    cam = _cam(room.CAM, 4)
    tex, planes = room.make_scene(3)
    assert scenes._room_planes(room.ROOM) == planes
    _, poses = room.make_sequence(40, 0)
    want = np.stack([room.render((tex, planes), p, cam) for p in poses[::5]])
    got = scenes.render_frames(([torch.from_numpy(t) for t in tex], planes),
                               poses[::5], _mine(cam), "cpu")
    assert np.abs(want.astype(int) - got.astype(int)).max() == 0


def test_street_frames_equal_the_tools(tools):
    room, street = tools
    cam = _cam(street.CAM, 4)
    tex, planes = street.make_street_scene(1)
    assert scenes._street_planes(street.OUTER, street.INNER,
                                 street.WALL_H) == planes
    _, poses = street.make_sequence(100)
    want = np.stack([room.render((tex, planes), p, cam) for p in poses[::20]])
    got = scenes.render_frames(([torch.from_numpy(t) for t in tex], planes),
                               poses[::20], _mine(cam), "cpu")
    assert np.abs(want.astype(int) - got.astype(int)).max() == 0


# the street tool's drive (KITTI-class, 10 Hz), as a street configuration
# would state it
STREET = {"fps": 10.0, "radius": 80.0, "step_rad": 0.01125}


def test_trajectories_equal_the_tools(tools):
    import json

    room, street = tools
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "euroc-mav.json")) as f:
        room_traj = json.load(f)["trajectory"]
    for traj, (times, poses) in ((room_traj, room.make_sequence(240, 0)),
                                 (STREET, street.make_sequence(620))):
        t2, p2 = scenes.trajectory(traj, len(times))
        assert np.array_equal(times, t2) and np.array_equal(poses, p2)


def test_odometry_equals_the_tools(tools):
    _, street = tools
    _, poses = street.make_sequence(50)
    rng = np.random.default_rng(7)
    walk = np.zeros(3)
    want = []
    for i, p in enumerate(poses):
        walk += rng.normal(0.0, 0.01, 3)
        want.append(street.drifted_pose_cw(p, walk, 4e-5, i))
    got = scenes.drifted_odometry(poses, 0.01, 4e-5,
                                  np.random.default_rng(7))
    assert np.allclose(np.stack(want), got, rtol=0, atol=1e-12)


def test_textures_follow_the_seed():
    cfg = {"kind": "room", "room": [10.0, 3.0, 10.0], "tex_size": 64}
    a = scenes.make_scene(cfg, 2 ** 40 + 5, "cpu")[0]
    b = scenes.make_scene(cfg, 2 ** 40 + 5, "cpu")[0]
    c = scenes.make_scene(cfg, 2 ** 40 + 6, "cpu")[0]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
