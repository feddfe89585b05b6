"""Whole runs of the KITTI-class tools through both packages on the CPU: a
tiny ``tools/torch_run_kitti_synthetic.py`` drive (scale mode, a blackout,
the map saved) and relocation pass against ``tools/run_kitti_synthetic.py``'s,
each package's map loaded by the other, and ``tools/torch_run_kitti.py``
against ``tools/run_kitti.py`` over rendered frames in KITTI's layout.

As in ``tests/test_torch_tools_euroc.py`` the port builds its pyramids
with the JAX package's band matmuls, so the front-ends agree: the trackers'
ids are equal frame by frame, and keyframes, track resets, closure
statistics and relocation stages are equal. The local BAs part the maps by
a few points (map points within 1 %, ATE within 1e-3 m): the JAX package
runs its LM in f32, the port in f64 (``ops/ba.solve_ba_two_stage``). Those
two comparisons drive both packages through the blackout and the
relocation pass (about two minutes on one CPU thread) and are marked slow.
The saved maps of a three-frame drive load in either package to the same
keyframes, poses and map points."""
import os
import types

import numpy as np
import pytest
import torch
from torch_tools_shared import (port_audit_in_jax_mapper, record_tracks,
                                share_jax_pyramid)

import run_kitti
import run_kitti_synthetic as jkitti
import torch_run_euroc_synthetic as teuroc
import torch_run_kitti
import torch_run_kitti_synthetic as tkitti
from slam_tpu.frontends.descriptor_tracker import DescriptorTracker as JT
from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker as TT

torch.set_num_threads(1)
FRAMES, BLACKOUT, RELOC_FRAMES = 6, (3, 4), 3
MAP_FRAMES = 3


def _redirect_tmp(mp, tmp):
    """The JAX tool's fixed /tmp paths, sent to ``tmp``."""
    mp.setattr(jkitti, "os", types.SimpleNamespace(
        path=types.SimpleNamespace(join=lambda a, *rest: os.path.join(
            str(tmp) if a == "/tmp" else a, *rest))))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Both packages' drives and relocation passes, on the shared pyramid;
    the JAX tool's fixed /tmp paths are redirected to a temporary
    directory."""
    tmp = tmp_path_factory.mktemp("kitti")
    mp = pytest.MonkeyPatch()
    try:
        port_audit_in_jax_mapper(mp)
        share_jax_pyramid(mp)
        jt, tt = record_tracks(mp, JT), record_tracks(mp, TT)
        _redirect_tmp(mp, tmp)
        want = jkitti.run(n_frames=FRAMES, blackout=BLACKOUT, reloc=False,
                          progress=False)
        port_map = str(tmp / "port_map.npz")
        got, _, _ = tkitti.drive(n_frames=FRAMES, blackout=BLACKOUT,
                                 reloc=False, progress=False,
                                 map_path=port_map, device="cpu")
        jax_map = str(tmp / "kitti_synth_map.npz")
        scene = tkitti.make_street_scene(0)
        reloc = {
            "jax": jkitti.run_relocation_pass(scene, jax_map, 0,
                                              n_frames=RELOC_FRAMES),
            "port": tkitti.run_relocation_pass(scene, port_map, 0,
                                               n_frames=RELOC_FRAMES,
                                               device="cpu")}
    finally:
        mp.undo()
    return dict(want=want, got=got, jt=jt, tt=tt, reloc=reloc)


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """Each package's map of a short drive without a blackout, saved."""
    tmp = tmp_path_factory.mktemp("kitti_maps")
    mp = pytest.MonkeyPatch()
    try:
        port_audit_in_jax_mapper(mp)
        _redirect_tmp(mp, tmp)
        jkitti.run(n_frames=MAP_FRAMES, blackout=None, reloc=False,
                   progress=False)
        port_map = str(tmp / "port_map.npz")
        tkitti.drive(n_frames=MAP_FRAMES, blackout=None, reloc=False,
                     progress=False, map_path=port_map, device="cpu")
    finally:
        mp.undo()
    return {"jax": str(tmp / "kitti_synth_map.npz"), "port": port_map}


@pytest.mark.slow
def test_drive_equals_jax_tool(sessions):
    want, got = sessions["want"], sessions["got"]
    assert got.keys() == want.keys()
    for k in ("frames", "trajectory_m", "keyframes", "loop_closures",
              "track_resets", "loop_stats"):
        assert got[k] == want[k], k
    assert got["keyframes"] == FRAMES            # scale mode: every frame
    assert got["track_resets"] == 1              # the blackout
    assert abs(got["ate_odometry_m"] - want["ate_odometry_m"]) <= 1e-12
    # the local BAs round differently in the two packages (f32 against
    # f64) and a few points fall on either side of the map's gates
    assert abs(got["map_points"] - want["map_points"]) \
        <= 0.01 * want["map_points"], (got, want)
    assert abs(got["ate_slam_m"] - want["ate_slam_m"]) <= 1e-3, (got, want)
    assert got["ate_slam_m"] < got["ate_odometry_m"]
    jt, tt = sessions["jt"], sessions["tt"]
    assert len(tt) == len(jt) == FRAMES + RELOC_FRAMES
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b, a)


@pytest.mark.slow
def test_relocation_equal_in_both_packages(sessions):
    reloc = sessions["reloc"]
    want = reloc["jax"]
    assert want["atlas_keyframes"] == FRAMES
    assert want["candidates_considered"] >= 1, want
    for name, got in reloc.items():
        assert got == want, name


def test_saved_maps_load_across_packages(maps):
    """Each saved map loads in both packages to the same keyframes (ids,
    poses, keypoints, map-point links) and map points (positions,
    descriptors, observations)."""
    from slam_tpu.ids import MapId as JMapId
    from slam_tpu.map.serialization import load_map_db as jload
    from slam_tpu.ops.bow import BowIndex as JBowIndex
    from slam_tpu.params import ParametersSlam as JParametersSlam
    from slam_tpu_torch.ids import MapId
    from slam_tpu_torch.map.serialization import load_map_db as tload
    from slam_tpu_torch.ops.bow import BowIndex
    from slam_tpu_torch.params import ParametersSlam

    for path in maps.values():
        a = jload(JMapId(0), JBowIndex(JParametersSlam()), path)
        b = tload(MapId(0), BowIndex(ParametersSlam(), device="cpu"), path)
        assert sorted(map(int, a.keyframes)) == sorted(map(int, b.keyframes))
        assert len(a.keyframes) == MAP_FRAMES
        for k, kf in a.keyframes.items():
            kt = b.keyframes[type(next(iter(b.keyframes)))(int(k))]
            np.testing.assert_array_equal(kt.pose_cw, kf.pose_cw)
            np.testing.assert_array_equal(kt.map_points, kf.map_points)
            np.testing.assert_array_equal(kt.shared.pts, kf.shared.pts)
            np.testing.assert_array_equal(kt.shared.descriptors,
                                          kf.shared.descriptors)
        assert sorted(map(int, a.map_points)) == sorted(map(int,
                                                            b.map_points))
        assert len(a.map_points) > 100
        for k, mp in a.map_points.items():
            mt = b.map_points[type(next(iter(b.map_points)))(int(k))]
            np.testing.assert_array_equal(mt.position, mp.position)
            np.testing.assert_array_equal(mt.descriptor, mp.descriptor)
            assert sorted(map(int, mt.observations)) == sorted(
                map(int, mp.observations))


def test_kitti_layout_equals_jax_harness(tmp_path, monkeypatch, capsys):
    """Three street frames as a KITTI odometry sequence (image_0 PNGs, a
    poses file of 3x4 T_w_cam rows) through both harnesses."""
    import sys

    from PIL import Image

    share_jax_pyramid(monkeypatch)
    port_audit_in_jax_mapper(monkeypatch)
    scene = tkitti.make_street_scene(0)
    _, poses = tkitti.make_sequence(3)
    (tmp_path / "seq" / "image_0").mkdir(parents=True)
    for i, p in enumerate(poses):
        Image.fromarray(teuroc.render(scene, p, cam=tkitti.CAM)).save(
            tmp_path / "seq" / "image_0" / f"{i:06d}.png")
    np.savetxt(tmp_path / "poses.txt",
               np.stack([np.linalg.inv(p)[:3].reshape(-1) for p in poses]))
    args = [str(tmp_path / "seq"), "--poses", str(tmp_path / "poses.txt"),
            "--drift", "0.01"]
    monkeypatch.setattr(sys, "argv", ["run_kitti.py", *args, "--out",
                                      str(tmp_path / "jax.csv")])
    run_kitti.main()
    want = capsys.readouterr().out.splitlines()[-1]
    mapper = torch_run_kitti.main([*args, "--out", str(tmp_path / "port.csv"),
                                   "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()[-1]
    assert got.split(";")[1] == want.split(";")[1]
    assert len(mapper.map_db.keyframes) >= 2
    np.testing.assert_allclose(
        np.genfromtxt(tmp_path / "port.csv", delimiter=","),
        np.genfromtxt(tmp_path / "jax.csv", delimiter=","), atol=1e-6)
