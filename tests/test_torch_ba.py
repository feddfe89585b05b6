"""Parity of the torch port's dense-Schur LM bundle adjustment with the JAX
package's ``ops/ba._lm_run`` on CPU, on sliding-window problems shaped like
the device VO's (K = 8 poses, M = 512 points, O = M * K observations, K - 1
odometry edges, oldest pose fixed). Two problems run batched in the port
and one by one in JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from slam_tpu.geometry import se3
from slam_tpu.ops import ba as jba
from slam_tpu_torch.ops import ba as tba

torch.set_num_threads(1)
K, M = 8, 512
HUBER = float(np.sqrt(jba.CHI2_THRESHOLD))


def _window_problem(seed):
    rng = np.random.default_rng(seed)
    truth = [np.linalg.inv(se3.se3_exp(np.r_[0.0, 0.02 * k, 0.0,
                                             0.12 * k, 0.0, 0.0]))
             for k in range(K)]
    poses = np.stack([se3.se3_exp(rng.normal(0, [3e-3] * 3 + [1e-2] * 3))
                      @ T for T in truth]).astype(np.float32)
    pts_true = rng.uniform([-2, -2, 3], [3, 2, 8], (M, 3))
    points = (pts_true + rng.normal(0, 0.03, (M, 3))).astype(np.float32)
    obs_mp = np.repeat(np.arange(M), K).astype(np.int32)
    obs_kf = np.tile(np.arange(K), M).astype(np.int32)
    pc = np.einsum("oij,oj->oi", np.stack(truth)[obs_kf, :3, :3],
                   pts_true[obs_mp]) + np.stack(truth)[obs_kf, :3, 3]
    meas = pc[:, :2] / pc[:, 2:3] + rng.normal(0, 1e-3, (M * K, 2))
    meas[rng.random(M * K) < 0.02] += 0.05          # a few outliers (Huber)
    obs_valid = rng.random(M * K) < 0.6
    # as in the VO's window BA: a point needs >= 2 observations to be free
    n_obs = obs_valid.reshape(M, K).sum(axis=1)
    points_fixed = (rng.random(M) < 0.1) | (n_obs < 2)
    pe_b = np.arange(1, K, dtype=np.int32)
    pe_a = pe_b - 1
    pe_meas = np.stack([truth[b] @ np.linalg.inv(truth[a])
                        for a, b in zip(pe_a, pe_b)]).astype(np.float32)
    sqrt_info = np.diag([1e4] * 3 + [1e3] * 3).astype(np.float32)
    return dict(
        poses=poses, pose_fixed=np.arange(K) == 0, points=points,
        points_fixed=points_fixed, obs_kf=obs_kf, obs_mp=obs_mp,
        obs_meas=meas.astype(np.float32),
        obs_sqrt_info=np.full(M * K, 400.0, np.float32), obs_valid=obs_valid,
        pe_a=pe_a, pe_b=pe_b, pe_meas=pe_meas,
        pe_sqrt_info=np.broadcast_to(sqrt_info, (K - 1, 6, 6)).copy(),
        pe_valid=np.arange(K - 1) != 3,
        pr_idx=np.array([2], np.int32),
        pr_meas=truth[2][None].astype(np.float32),
        pr_sqrt_info=(np.eye(6, dtype=np.float32) * 50.0)[None],
        pr_valid=np.array([True]))


def _torch_problem(problems):
    def stack(name):
        a = np.stack([p[name] for p in problems])
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        return torch.from_numpy(a)
    return tba.BAProblem(*(stack(f) for f in tba.BAProblem._fields))


def test_pick_cg_iters_matches_jax():
    for k, m in [(8, 512), (16, 1024), (64, 65536), (32, 32768)]:
        assert tba.pick_cg_iters(k, m) == jba.pick_cg_iters(k, m)
    assert tba.pick_cg_iters(K, M) == 0          # the window BA: dense Schur


def test_dense_schur_lm_matches_jax():
    problems = [_window_problem(0), _window_problem(1)]
    lm = jax.jit(jba._lm_run, static_argnums=(1, 2))
    want = [lm(jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
               3, 0, HUBER, 1e-4) for p in problems]
    got = tba.lm_run(_torch_problem(problems), 3, 0, HUBER, 1e-4)
    for s, w in enumerate(want):
        # the solve moves poses by cm and points by dm: check it did work
        assert np.abs(np.asarray(w.poses) - problems[s]["poses"]).max() > 1e-3
        # f32 LM over 4096 residuals summed in another order: 1e-4 (for the
        # points, 3-8 m away, relative; in float64 the two agree to 1e-10)
        np.testing.assert_allclose(got.poses[s].numpy(), np.asarray(w.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(got.points[s].numpy(),
                                   np.asarray(w.points), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(got.cost[s]), float(w.cost),
                                   rtol=1e-4)
        np.testing.assert_allclose(got.obs_chi2[s].numpy(),
                                   np.asarray(w.obs_chi2), rtol=1e-3,
                                   atol=1e-3)


def test_dense_schur_lm_matches_jax_in_float64():
    """The same solve in float64: agreement to rounding shows that the f32
    tolerance above covers only summation order."""
    p = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
         for k, v in _window_problem(0).items()}
    with jax.enable_x64(True):
        w = jax.jit(jba._lm_run, static_argnums=(1, 2))(
            jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
            3, 0, HUBER, 1e-4)
        w = jax.tree.map(np.asarray, w)
    got = tba.lm_run(_torch_problem([p]), 3, 0, HUBER, 1e-4)
    assert got.poses.dtype == torch.float64
    np.testing.assert_allclose(got.poses[0].numpy(), w.poses, atol=1e-10)
    np.testing.assert_allclose(got.points[0].numpy(), w.points, atol=1e-8)
    np.testing.assert_allclose(float(got.cost[0]), float(w.cost), rtol=1e-10)


def test_pcg_branch_matches_jax():
    """The implicit-Schur PCG branch (``cg_iters > 0``): on a window
    problem, batched over two sequences, it matches the JAX package's PCG
    (48 = 6 K steps, the budget ``pick_cg_iters`` gives) within the dense
    test's tolerances."""
    problems = [_window_problem(0), _window_problem(1)]
    lm = jax.jit(jba._lm_run, static_argnums=(1, 2))
    got = tba.lm_run(_torch_problem(problems), 2, 48, HUBER, 1e-4)
    for s, p in enumerate(problems):
        w = lm(jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
               2, 48, HUBER, 1e-4)
        assert np.abs(np.asarray(w.poses) - p["poses"]).max() > 1e-3
        np.testing.assert_allclose(got.poses[s].numpy(), np.asarray(w.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(got.points[s].numpy(),
                                   np.asarray(w.points), rtol=1e-4, atol=1e-4)
