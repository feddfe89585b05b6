"""The plain reference against the program's own paths on the CPU: the
local BA's LM (float64 on both sides: camera centres within 1e-6 m; the
float32 control at least 1e-3 m away), the nearest-codeword search and the
closure stack's descriptor matching (exact)."""
import numpy as np
import pytest
import torch

from harness import reference as R


def _problem(seed):
    from slam_tpu_torch.ops import ba

    rng = np.random.default_rng(seed)
    S, K, M, O = 1, 8, 96, 512
    poses = np.zeros((S, K, 4, 4))
    for k in range(K):
        c, s = np.cos(0.05 * k), np.sin(0.05 * k)
        poses[0, k] = [[c, 0, s, 0.1 * k], [0, 1, 0, 0.02 * k],
                       [-s, 0, c, 0.05], [0, 0, 0, 1]]
    pts = rng.normal(0, 1, (S, M, 3)) + [0, 0, 5.0]
    kf, mp = rng.integers(0, K, (S, O)), rng.integers(0, M, (S, O))
    T = poses[0][kf[0]]
    pc = np.einsum("oij,oj->oi", T[:, :3, :3], pts[0][mp[0]]) + T[:, :3, 3]
    meas = (pc[:, :2] / pc[:, 2:])[None] + rng.normal(0, 0.002, (S, O, 2))
    meas[0, :10] += 0.05                                   # outliers
    noisy = poses.copy()
    noisy[..., :3, 3] += rng.normal(0, 0.02, (S, K, 3))
    pf = np.zeros((S, K), bool)
    pf[0, :2] = True
    lf = np.zeros((S, M), bool)
    lf[0, :3] = True
    a, b = np.array([[2, 3, 4, 5]]), np.array([[3, 4, 5, 6]])
    pe = np.stack([poses[0, j] @ np.linalg.inv(poses[0, i])
                   for i, j in zip(a[0], b[0])])[None]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    i64 = lambda x: torch.tensor(x, dtype=torch.int64)    # noqa: E731
    return ba.BAProblem(
        f32(noisy), torch.tensor(pf), f32(pts + rng.normal(0, .05, pts.shape)),
        torch.tensor(lf), i64(kf), i64(mp), f32(meas),
        f32(np.full((S, O), 400.0)), torch.ones(S, O, dtype=torch.bool),
        i64(a), i64(b), f32(pe), f32(np.tile(np.eye(6) * 10, (S, 4, 1, 1))),
        torch.tensor([[True, True, False, True]]), i64([[7]]),
        f32(poses[:, [7]]), f32(np.tile(np.eye(6) * 5, (S, 1, 1, 1))),
        torch.ones(S, 1, dtype=torch.bool))


@pytest.mark.parametrize("cg_iters", [0, 12])
def test_two_stage_lm_matches_the_program(cg_iters):
    from slam_tpu_torch.ops import ba

    p = _problem(0)
    fixed2 = torch.zeros(1, 8, dtype=torch.bool)
    fixed2[0, 0] = True
    info = torch.eye(6)[None] * 100
    prog = ba.solve_ba_two_stage_eager(p, fixed2, torch.tensor([7]), info, 5,
                                       cg_iters)
    ref, _, _ = R.two_stage_lm(R.problem(list(p), 0, torch.float64, "cpu"),
                               fixed2[0], 7, info[0], 5, cg_iters,
                               ba.HUBER_DELTA, 1e-4)
    c_ref = R.camera_centers(ref.numpy())
    gap = np.abs(R.camera_centers(prog.poses[0].double().numpy())
                 - c_ref).max()
    assert gap < 1e-6
    ctl, _, _ = R.two_stage_lm(R.problem(list(p), 0, torch.float32, "cpu"),
                               fixed2[0], 7, info[0], 5, cg_iters,
                               ba.HUBER_DELTA, 1e-4)
    assert np.abs(R.camera_centers(ctl.double().numpy()) - c_ref).max() > 1e-3


def test_lm_run_matches_the_program():
    from slam_tpu_torch.ops import ba

    p = _problem(1)
    prog = ba.solve_ba_eager(p, 5, 0)
    ref, _, _ = R.lm_run(R.problem(list(p), 0, torch.float64, "cpu"), 5, 0,
                         ba.HUBER_DELTA, 1e-4)
    assert np.abs(R.camera_centers(prog.poses[0].double().numpy())
                  - R.camera_centers(ref.numpy())).max() < 1e-6


def test_hamming_argmin_matches_the_program():
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin_plain

    rng = np.random.default_rng(2)
    code = rng.integers(0, 2 ** 32, (5000, 8), dtype=np.uint32)
    code[4000:] = code[3999]                  # ties: the first index wins
    desc = np.concatenate([rng.integers(0, 2 ** 32, (60, 8), dtype=np.uint32),
                           code[[3999, 10, 4500]] ^ np.uint32(1)])
    d, i = R.hamming_argmin(desc, code, "cpu", block=1024)
    pd, pi = hamming_argmin_plain(torch.from_numpy(desc.view(np.int32)),
                                  torch.from_numpy(code.view(np.int32)))
    assert np.array_equal(i, pi.numpy()) and np.array_equal(d, pd.numpy())


def test_matching_count_matches_the_program():
    from slam_tpu_torch.ops.hamming import hamming_matrix_host
    from slam_tpu_torch.pipeline.device_slam import _mutual_nn_lowe

    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, (192, 8), dtype=np.uint32)
    b = a.copy()
    b[::3] = rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32)
    b ^= (rng.random((192, 8)) < 0.02).astype(np.uint32) << 5
    va, vb = rng.random(192) < 0.9, rng.random(192) < 0.9
    i, _ = _mutual_nn_lowe(hamming_matrix_host(a, b), va, vb, 0.9)
    assert R.mutual_nn_lowe_count(a, b, va, vb, 0.9, 50) == len(i) > 50


def test_tf32_rounding_and_best_score():
    x = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -12, 1 + 2 ** -10, -2.5],
                 np.float32)
    assert R.round_tf32(x).tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -10,
                                        -2.5]
    # signatures as the retrieval makes them: square roots of a frame's
    # word counts over 512 words, normalised
    rng = np.random.default_rng(4)
    h = np.sqrt(rng.multinomial(600, np.full(512, 1 / 512), size=64))
    ring = (h / np.linalg.norm(h, axis=1, keepdims=True)).astype(np.float32)
    q = ring[5]
    assert R.best_score(ring, q) == pytest.approx(1.0, abs=1e-6)
    # the fleet's control: TF32 inputs move a score past the cell's limit,
    # float32 products stay below it
    import json
    import os

    from conftest import BENCH

    with open(os.path.join(BENCH, "cells", "euroc-mav.fleet.json")) as f:
        limit = json.load(f)["limits"]["retrieval_score_gap"]
    ref = R.best_score(ring[6:], q)
    assert abs(R.best_score(ring[6:], q, tf32=True) - ref) > limit
    assert abs(float((ring[6:] @ q).max()) - ref) < limit
    assert R.best_score(ring[:0], q) == -1.0


# ---------------------------------------------------------------- device VO

def _settings():
    import json
    import os

    from conftest import BENCH

    with open(os.path.join(BENCH, "configs", "euroc-mav.json")) as f:
        cfg = json.load(f)
    return cfg, R.SolverSettings.of(cfg)


def _centre_gap(a, b):
    return np.abs(R.camera_centers(a.double().numpy())
                  - R.camera_centers(b.double().numpy())).max()


def test_pose_lm_matches_the_program():
    """The tracking's pose-only LM, set up again from what the program
    hands it: camera centres within 1e-5 m of the program's float32
    solve, which moved the prediction by millimetres."""
    from slam_tpu_torch.pipeline import device_vo as dv

    cfg, sc = _settings()
    S, M = 2, 64
    vo_cfg = dv.DeviceVOConfig(width=752, height=480, lm_capacity=M,
                               loop_every=0,
                               **{k: cfg["device_vo"][k] for k in (
                                   "ba_iterations", "odom_pos_weight",
                                   "odom_rot_weight", "obs_weight_scale",
                                   "maturity_ramp", "maturity_floor")})
    rng = np.random.default_rng(5)
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    c, n = np.cos(0.1), np.sin(0.1)
    pose_true = f(np.tile([[c, 0, n, 0.2], [0, 1, 0, 0.01], [-n, 0, c, 0.1],
                           [0, 0, 0, 1]], (S, 1, 1)))
    pred = pose_true.clone()
    pred[:, :3, 3] += f(rng.normal(0, 0.02, (S, 3)))
    lm_pos = f(rng.normal(0, 1, (S, M, 3)) + [0, 0, 4.0])
    lm_n_obs = torch.tensor(rng.integers(1, 12, (S, M)), dtype=torch.int32)
    pc = (lm_pos @ pose_true[:, :3, :3].transpose(-1, -2)
          + pose_true[:, None, :3, 3])
    meas = pc[..., :2] / pc[..., 2:] + f(rng.normal(0, 1.0 / sc.focal,
                                                    (S, M, 2)))
    meas[:, :3] += 0.05                                    # outliers
    matched = torch.tensor(rng.random((S, M)) < 0.8)
    weight = sc.focal * sc.obs_weight_scale * torch.clamp(
        (lm_n_obs.float() - 1.0) / sc.maturity_ramp, sc.maturity_floor, 1.0)
    st = dv.init_state(vo_cfg, 16, S, "cpu")._replace(
        lm_pos=lm_pos, lm_n_obs=lm_n_obs, prev_pose_cw=pred)
    prog = dv._pose_ba(st, pred, meas, matched, vo_cfg, weight)
    for s in range(S):
        ref = R.pose_lm(lm_pos[s], lm_n_obs[s], pred[s], meas[s],
                        matched[s], sc, torch.float64, "cpu")
        assert _centre_gap(prog[s], ref) < 1e-5
        assert _centre_gap(pred[s], ref) > 1e-3     # the solve moved it


def test_loop_codebook_is_the_programs():
    import json
    import os

    from conftest import BENCH, ROOT
    from slam_tpu_torch.pipeline.device_vo import _loop_codebook

    with open(os.path.join(BENCH, "cells", "euroc-mav.fleet.json")) as f:
        path = os.path.join(ROOT, json.load(f)["vocabulary"])
    assert np.array_equal(R.loop_codebook(path, 512), _loop_codebook(512))
