"""Whole runs of the EuRoC-class tools through both packages on the CPU:
``tools/torch_run_euroc_synthetic.py`` against ``tools/run_euroc_synthetic
.py``, and ``tools/torch_run_euroc.py`` against ``tools/run_euroc.py`` over
the same rendered frames written in EuRoC's ASL layout.

The port builds its pyramids with the JAX package's band matmuls here: the
two packages' own pyramids differ by one gray at a few rint ties (ROADMAP
section 3), which reorders nearly equal corners and lets the sessions part
from the first frame. On the shared pyramid the trackers' ids are equal
frame by frame, and keyframes, map points, closures and both ATEs are
equal (ATE within 1e-6 m). The JAX tools end with the port's map audit
(``torch_tools_shared.port_audit_in_jax_mapper``). The six-frame run of
the rendered-room tools takes about a minute on one CPU thread and is
marked slow; the four-frame ASL sequence stays fast."""
import os
import sys

import numpy as np
import pytest
import torch
from torch_tools_shared import (port_audit_in_jax_mapper, record_tracks,
                                share_jax_pyramid)

import run_euroc
import run_euroc_synthetic as jeuroc
import torch_run_euroc
import torch_run_euroc_synthetic as teuroc
from slam_tpu.frontends.descriptor_tracker import DescriptorTracker as JT
from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker as TT
from slam_tpu_torch.geometry import se3

torch.set_num_threads(1)
FRAMES = 6


@pytest.fixture()
def shared(monkeypatch):
    port_audit_in_jax_mapper(monkeypatch)
    share_jax_pyramid(monkeypatch)
    return record_tracks(monkeypatch, JT), record_tracks(monkeypatch, TT)


@pytest.mark.slow
def test_run_equals_jax_tool_on_shared_pyramid(shared, tmp_path):
    jt, tt = shared
    want = jeuroc.run(n_frames=FRAMES, drift=0.004,
                      out=str(tmp_path / "jax.csv"), progress=False)
    got = teuroc.run(n_frames=FRAMES, drift=0.004,
                     out=str(tmp_path / "port.csv"), progress=False,
                     device="cpu")
    assert got.keys() == want.keys()
    for k in ("frames", "keyframes", "map_points", "loop_closures"):
        assert got[k] == want[k], k
    assert got["keyframes"] >= 3 and got["map_points"] > 300
    assert abs(got["ate_odometry_m"] - want["ate_odometry_m"]) <= 1e-12
    assert abs(got["ate_slam_m"] - want["ate_slam_m"]) <= 1e-6
    assert got["ate_slam_m"] < got["ate_odometry_m"]
    assert len(jt) == len(tt) == FRAMES
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(
        np.genfromtxt(tmp_path / "port.csv", delimiter=","),
        np.genfromtxt(tmp_path / "jax.csv", delimiter=","), atol=1e-6)


def _write_asl(root, n):
    """``n`` room frames as an ASL sequence: cam0 PNGs named by their
    nanosecond stamps (20 Hz) and the body's ground truth (px, py, pz, qw,
    qx, qy, qz); the camera is the body."""
    from PIL import Image

    scene = teuroc.make_scene(0)
    _, poses = teuroc.make_sequence(n)
    cam = root / "mav0" / "cam0" / "data"
    cam.mkdir(parents=True)
    gt = root / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    rows = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for i, pose in enumerate(poses):
        t_ns = 1403636579763555584 + i * 50_000_000
        Image.fromarray(teuroc.render(scene, pose)).save(cam / f"{t_ns}.png")
        T_wc = np.linalg.inv(pose)
        x, y, z, w = se3.rmat_to_quat(T_wc[:3, :3])
        rows.append(",".join(str(v) for v in (t_ns, *T_wc[:3, 3], w, x, y,
                                              z)))
    (gt / "data.csv").write_text("\n".join(rows) + "\n")
    return poses


def test_asl_sequence_equals_jax_harness(shared, tmp_path, monkeypatch,
                                         capsys):
    jt, tt = shared
    poses = _write_asl(tmp_path / "seq", 4)
    args = [str(tmp_path / "seq"), "--stride", "1", "--drift", "0.004",
            "--map", str(tmp_path / "map.npz")]
    monkeypatch.setattr(sys, "argv", ["run_euroc.py", *args, "--out",
                                      str(tmp_path / "jax.csv")])
    run_euroc.main()
    want_out = capsys.readouterr().out
    mapper = torch_run_euroc.main([*args, "--out", str(tmp_path / "port.csv"),
                                   "--device", "cpu"])
    got_out = capsys.readouterr().out
    assert len(mapper.map_db.keyframes) >= 2
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b, a)
    est = np.genfromtxt(tmp_path / "port.csv", delimiter=",")
    np.testing.assert_allclose(
        est, np.genfromtxt(tmp_path / "jax.csv", delimiter=","), atol=1e-6)
    # the same keyframe count and ATE line, and the camera centres near the
    # truth (4 frames of 0.004 m drift)
    pick = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith(("ATE", "wrote"))]
    assert pick(got_out)[-1] == pick(want_out)[-1]
    assert pick(got_out)[0].split(";")[1] == pick(want_out)[0].split(";")[1]
    gt = torch_run_euroc.load_groundtruth(str(tmp_path / "seq"))
    assert torch_run_euroc.ate_rmse(est, gt) < 0.01
    assert os.path.getsize(tmp_path / "map.npz") > 0
    assert len(poses) == 4
