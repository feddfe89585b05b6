"""The device-VO tools through both packages on the CPU:
``tools/torch_run_device_vo_euroc.py`` against
``tools/run_device_vo_euroc.py`` and ``tools/torch_sweep_device_vo.py``
against ``tools/sweep_device_vo.py``, two chunks of the EuRoC-class room at
S=2 with the window BA (the default preset). Each package builds its own
pyramid here: the odometry's ATE is equal to 1e-12 m and the VO's within
1e-4 m (the two differ by about 2e-6 m on these frames). The port's
``--slam`` path, which closes nothing in two chunks (``loop_min_gap=40``),
tracks exactly as the VO alone. Every case is marked slow: the two
packages' runs take about two minutes on one CPU thread, and at one chunk
the window BA does not yet beat the odometry."""
import io
import json
import sys

import pytest
import torch
from torch_tools_shared import ROOT  # noqa: F401  (puts tools/ on the path)

import run_device_vo_euroc as jdvo
import sweep_device_vo as jsweep
import torch_run_device_vo_euroc as tdvo
import torch_sweep_device_vo as tsweep

torch.set_num_threads(1)
RUN = dict(n_frames=16, n_sequences=2, drift=0.008, window=8,
           preset="default", progress=False)


@pytest.fixture(scope="module")
def runs():
    return jdvo.run(**RUN), tdvo.run(**RUN, device="cpu")


@pytest.mark.slow
def test_room_vo_matches_jax_tool(runs):
    want, got = runs
    assert got.keys() == want.keys()
    for k in ("frames", "sequences", "drift", "slam", "closures_accepted",
              "window", "tile", "preset", "lowe"):
        assert got[k] == want[k], k
    for a, b in zip(want["per_sequence"], got["per_sequence"]):
        assert abs(a["ate_odometry_m"] - b["ate_odometry_m"]) <= 1e-12
        assert abs(a["ate_vo_m"] - b["ate_vo_m"]) <= 1e-4, (a, b)
    assert got["ate_vo_m_mean"] < got["ate_odometry_m_mean"]
    assert got["vo_keyframes_per_sec"] > 0


@pytest.mark.slow
def test_sweep_matches_jax_tool(runs, monkeypatch):
    """The sweep's one cell at the run's setting: the same row as the JAX
    sweep's within the tolerances above, and the port's row is the port's
    run rounded to 4 places."""
    argv = ["--frames", "16", "--sequences", "2", "--drifts", "0.008",
            "--tiles", "0", "--variants", "default"]
    monkeypatch.setattr(sys, "argv", ["sweep_device_vo.py", *argv])
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    jsweep.main()
    monkeypatch.undo()
    lines = out.getvalue().splitlines()
    want = json.loads(lines[0])
    rows = tsweep.sweep(frames=16, sequences=2, drifts=[0.008], tiles=[0],
                        variants=["default"], device="cpu")
    assert len(rows) == 1
    got = rows[0]
    assert got.keys() == want.keys()
    for k in ("tile", "drift", "variant", "ate_odometry_m",
              "beats_odometry"):
        assert got[k] == want[k], k
    assert abs(got["ate_vo_m"] - want["ate_vo_m"]) <= 1e-4 + 5e-5
    assert got["ate_vo_m"] == round(runs[1]["ate_vo_m_mean"], 4)
    # the summary table: same header, same layout
    table = tsweep.table(rows, [0], [0.008], ["default"]).splitlines()
    assert table[:2] == [ln for ln in lines if ln.startswith("|")][:2]
    assert table[2].split("|")[1:3] == [" euroc ", " 0.008 "]


@pytest.mark.slow
def test_slam_path_tracks_as_the_vo_alone(runs):
    got = tdvo.run(**RUN, slam=True, device="cpu")
    assert got["slam"] is True and got["closures_accepted"] == 0
    for a, b in zip(runs[1]["per_sequence"], got["per_sequence"]):
        assert abs(a["ate_vo_m"] - b["ate_vo_m"]) <= 1e-6, (a, b)
