"""The dataset harness's pure functions in the port
(``tools/torch_run_euroc.py``): the cases of ``tests/test_tools_harness.py``
run against the twin, each result also held equal to the original's
(``tools/run_euroc.py``) on the same inputs: ASL-format parsing,
ground-truth interpolation, drift injection, odometry CSV and the ATE."""
import numpy as np
import pytest
from torch_tools_shared import ROOT  # noqa: F401  (puts tools/ on the path)

import run_euroc
import torch_run_euroc

T0 = 1403636579763555584
T1 = 1403636579813555456


@pytest.fixture()
def euroc_dir(tmp_path):
    cam = tmp_path / "mav0" / "cam0" / "data"
    cam.mkdir(parents=True)
    for t in (T0, T1):
        (cam / f"{t}.png").write_bytes(b"")
    gt_dir = tmp_path / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True)
    rows = ["#timestamp,px,py,pz,qw,qx,qy,qz,vx"]
    for i, t in enumerate((T0, T1)):
        rows.append(f"{t},{i * 0.1},0.2,0.3,1,0,0,0,0")
    (gt_dir / "data.csv").write_text("\n".join(rows) + "\n")
    return tmp_path


class TestEurocHarness:
    def test_load_images_timestamps(self, euroc_dir):
        imgs = list(torch_run_euroc.load_images(str(euroc_dir)))
        assert len(imgs) == 2
        assert imgs[0][0] == pytest.approx(T0 * 1e-9)
        assert imgs[0][1].endswith(f"{T0}.png")
        assert len(list(torch_run_euroc.load_images(str(euroc_dir),
                                                    max_frames=1))) == 1
        assert imgs == list(run_euroc.load_images(str(euroc_dir)))

    def test_groundtruth_interpolation(self, euroc_dir):
        gt = torch_run_euroc.load_groundtruth(str(euroc_dir))
        assert gt is not None
        for a, b in zip(gt, run_euroc.load_groundtruth(str(euroc_dir))):
            np.testing.assert_array_equal(a, b)
        t_mid = (T0 + T1) / 2 * 1e-9
        T_cw, _ = torch_run_euroc.gt_pose_cw(t_mid, gt, np.zeros(3), 0.0,
                                             np.random.default_rng(0))
        # identity rotation; camera center at the interpolated position
        np.testing.assert_allclose(T_cw[:3, :3], np.eye(3), atol=1e-12)
        np.testing.assert_allclose(-T_cw[:3, 3], [0.05, 0.2, 0.3], atol=1e-9)

    def test_drift_injection_is_deterministic(self, euroc_dir):
        gt = torch_run_euroc.load_groundtruth(str(euroc_dir))
        t_mid = (T0 + T1) / 2 * 1e-9
        clean, _ = torch_run_euroc.gt_pose_cw(t_mid, gt, np.zeros(3), 0.0,
                                              np.random.default_rng(0))
        d1, s1 = torch_run_euroc.gt_pose_cw(t_mid, gt, np.zeros(3), 0.01,
                                            np.random.default_rng(7))
        d2, s2 = torch_run_euroc.gt_pose_cw(t_mid, gt, np.zeros(3), 0.01,
                                            np.random.default_rng(7))
        assert not np.allclose(d1, clean)
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(s1, s2)
        dj, sj = run_euroc.gt_pose_cw(t_mid, gt, np.zeros(3), 0.01,
                                      np.random.default_rng(7))
        np.testing.assert_array_equal(d1, dj)
        np.testing.assert_array_equal(s1, sj)

    def test_odometry_csv_roundtrip(self, tmp_path):
        path = tmp_path / "odo.csv"
        path.write_text("1.0,1,2,3,0,0,0,1\n2.0,4,5,6,0,0,0,1\n")
        ts, ps, qs = torch_run_euroc.load_odometry_csv(str(path))
        np.testing.assert_array_equal(ts, [1.0, 2.0])
        np.testing.assert_array_equal(ps[1], [4, 5, 6])
        np.testing.assert_array_equal(qs[0], [0, 0, 0, 1])
        for a, b in zip((ts, ps, qs), run_euroc.load_odometry_csv(str(path))):
            np.testing.assert_array_equal(a, b)

    def test_ate_rmse(self):
        ts = np.array([0.0, 1.0, 2.0, 3.0])
        ps = np.stack([ts, np.zeros(4), np.zeros(4)], axis=1)
        gt = (ts, ps, None)
        est = np.concatenate([ts[:, None], ps], axis=1)
        assert torch_run_euroc.ate_rmse(est, gt) == pytest.approx(0.0)
        # constant offset is removed by translation alignment
        est_off = est.copy()
        est_off[:, 1:4] += [1.0, -2.0, 0.5]
        assert torch_run_euroc.ate_rmse(est_off, gt) == pytest.approx(0.0)
        # alternating error survives alignment: +/-e on x -> RMSE == e
        est_alt = est.copy()
        est_alt[:, 1] += np.array([0.2, -0.2, 0.2, -0.2])
        assert torch_run_euroc.ate_rmse(est_alt, gt) == pytest.approx(0.2)
        assert torch_run_euroc.ate_rmse(est_alt, gt) == \
            run_euroc.ate_rmse(est_alt, gt)
