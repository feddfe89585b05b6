"""Parity of the port's interactive-path BA solvers with the JAX package on
CPU: the implicit-Schur PCG branch of ``lm_run`` (``cg_iters > 0``) and the
two-stage local-BA solve, at the local-BA benchmark's padded sizes
(K = 16, M = 512, O = 2048, E = 32, P = 1; ``bench.py`` ``bench_ba_solve``)
on a well-posed variant of its problem, with and without odometry edges.
Poses and points agree within 1e-4 (f32 solves of a few iterations),
per-observation chi2 within 1e-3 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import ba as jba
from slam_tpu_torch.ops import ba as tba

torch.set_num_threads(1)
K, M, O, E, P = 16, 512, 2048, 32, 1
ITERS = int(1 + np.sqrt(16))
TOL = 1e-4


def _bench_problem(edges: bool):
    """``bench_ba_solve``'s problem, made well-posed: keyframes 0.3 m apart,
    every point seen from 4 keyframes, every third point fixed. Near
    convergence an LM step's accept test compares costs that agree to
    about 1e-6 relative; where some points are weakly held (the bench's
    0.1 m baseline, fewer fixed points) a decision flipped by rounding moves
    them by up to 1e-3 in either package. ``edges`` turns on a chain of
    K - 1 odometry edges (the bench leaves every edge invalid)."""
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = 0.3 * np.arange(K)
    points = rng.uniform([-1, -1, 3], [1, 1, 6], (M, 3)).astype(np.float32)
    # every point seen from 4 distinct keyframes (the bench draws both
    # indices at random, which leaves points seen once, whose depth only
    # the damping holds)
    obs_mp = np.repeat(np.arange(M), O // M).astype(np.int32)
    obs_kf = np.concatenate([rng.choice(K, O // M, replace=False)
                             for _ in range(M)]).astype(np.int32)
    pc = (np.einsum("oij,oj->oi", poses[obs_kf, :3, :3], points[obs_mp])
          + poses[obs_kf, :3, 3])
    meas = pc[:, :2] / pc[:, 2:3] + rng.normal(0, 1e-3, (O, 2))
    pe_a = (np.arange(1, E + 1) % K).astype(np.int32)
    pe_b = (np.arange(0, E) % K).astype(np.int32)
    pe_meas = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    pe_si = np.zeros((E, 6, 6), np.float32)
    pe_valid = np.zeros(E, bool)
    if edges:
        for e in range(K - 1):
            pe_meas[e] = poses[pe_b[e]] @ np.linalg.inv(poses[pe_a[e]])
        pe_si[:K - 1] = np.diag([30.0] * 3 + [10.0] * 3)
        pe_valid[:K - 1] = True
    # perturb the free poses so the solve has work to do
    poses[1:, :3, 3] += rng.normal(0, 2e-3, (K - 1, 3)).astype(np.float32)
    return dict(
        poses=poses, pose_fixed=np.arange(K) == 0, points=points,
        # fixed points also fix the scale, which one fixed pose and every
        # point free (the bench's gauge) leave to rounding
        points_fixed=np.arange(M) % 3 == 0, obs_kf=obs_kf, obs_mp=obs_mp,
        obs_meas=meas.astype(np.float32),
        obs_sqrt_info=np.full(O, 100.0, np.float32),
        obs_valid=np.ones(O, bool), pe_a=pe_a, pe_b=pe_b, pe_meas=pe_meas,
        pe_sqrt_info=pe_si, pe_valid=pe_valid,
        pr_idx=np.zeros(P, np.int32),
        pr_meas=np.tile(np.eye(4, dtype=np.float32), (P, 1, 1)),
        pr_sqrt_info=np.zeros((P, 6, 6), np.float32),
        pr_valid=np.zeros(P, bool))


def _jax(prob):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})


def _torch(prob):
    def t(v):
        v = np.asarray(v)
        if v.dtype == np.int32:
            v = v.astype(np.int64)
        return torch.from_numpy(v.copy())[None]
    return tba.BAProblem(**{k: t(v) for k, v in prob.items()})


def _close(got, want):
    np.testing.assert_allclose(got.poses[0].numpy(), np.asarray(want.poses),
                               atol=TOL)
    np.testing.assert_allclose(got.points[0].numpy(),
                               np.asarray(want.points), atol=TOL)
    np.testing.assert_allclose(got.obs_chi2[0].numpy(),
                               np.asarray(want.obs_chi2), rtol=1e-3,
                               atol=1e-4)


def test_bench_problem_picks_dense_schur_and_pcg_when_forced():
    assert tba.pick_cg_iters(K, M) == jba.pick_cg_iters(K, M) == 0
    assert tba.pick_cg_iters(16, 1 << 17) == jba.pick_cg_iters(16, 1 << 17) \
        == 96
    assert tba.DENSE_SCHUR_MAX_KM == jba.DENSE_SCHUR_MAX_KM


@pytest.mark.parametrize("edges", [False, True], ids=["bench", "edges"])
def test_pcg_lm_run_matches_jax(edges):
    prob = _bench_problem(edges)
    cg = 96                                    # min(6 K, 96): the PCG branch
    want = jba.solve_ba(_jax(prob), iterations=ITERS, cg_iters=cg)
    got = tba.solve_ba(_torch(prob), iterations=ITERS, cg_iters=cg)
    _close(got, want)
    moved = np.abs(np.asarray(want.poses) - prob["poses"]).max()
    assert moved > 1e-4                        # the solve did something
    # and PCG converges to the dense solve on this well-posed problem
    dense = tba.solve_ba(_torch(prob), iterations=ITERS, cg_iters=0)
    np.testing.assert_allclose(got.poses.numpy(), dense.poses.numpy(),
                               atol=1e-3)


@pytest.mark.parametrize("cg", [0, 96], ids=["dense", "pcg"])
def test_two_stage_matches_jax(cg):
    """Stage 1 refines the newest pose with the rest fixed; stage 2 frees
    all but the first and anchors the stage-1 pose of the newest."""
    prob = _bench_problem(edges=True)
    prob["pose_fixed"] = np.arange(K) != K - 1
    stage2 = np.arange(K) == 0
    info = np.zeros((6, 6), np.float32)
    info[:3, :3] = np.eye(3) * 100.0
    info[3:, 3:] = np.eye(3) * 1.0
    want = jba.solve_ba_two_stage(_jax(prob), jnp.asarray(stage2),
                                  jnp.asarray(K - 1, jnp.int32),
                                  jnp.asarray(info), iterations=ITERS,
                                  cg_iters=cg)
    got = tba.solve_ba_two_stage(
        _torch(prob), torch.from_numpy(stage2)[None],
        torch.tensor([K - 1]), torch.from_numpy(info)[None],
        iterations=ITERS, cg_iters=cg)
    _close(got, want)
    np.testing.assert_allclose(got.cost.numpy()[0], float(want.cost),
                               rtol=1e-3)


def test_single_observation_point_blocks_are_singular_in_f32():
    """The port fault behind the interactive loop-closure divergence
    (ROADMAP section 3): a point seen from one keyframe has a rank-2
    normal block J^T J, and the damping (lambda + 1e-8, lambda starting at
    1e-4) that makes it invertible is its smallest eigenvalue, below one f32
    ulp of its largest entry: the damped block is singular to working
    precision, and each LAPACK decides its last LU pivot by rounding. Both
    packages build the block the same way."""
    rng = np.random.default_rng(0)
    pc = np.array([0.3, -0.2, 4.0])
    z = pc[2]
    Jproj = np.array([[1 / z, 0, -pc[0] / z ** 2], [0, 1 / z, -pc[1] / z ** 2]])
    R = jba.lie.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3)))
    J = (np.asarray(Jproj) @ np.asarray(R) * 458.0).astype(np.float32)
    H = J.T @ J
    damped = (H + np.float32(1e-4 + 1e-8) * np.eye(3, dtype=np.float32))
    smallest = np.linalg.eigvalsh(damped.astype(np.float64)).min()
    assert smallest < np.spacing(np.abs(damped).max())   # below one ulp
    assert np.linalg.cond(damped.astype(np.float64)) > 1e7
    # the port's solver forms the same block from the same Jacobian
    p = tba.BAProblem(
        poses=torch.eye(4)[None, None].clone(),
        pose_fixed=torch.ones(1, 1, dtype=torch.bool),
        points=torch.tensor([[[0.3, -0.2, 4.0]]]),
        points_fixed=torch.zeros(1, 1, dtype=torch.bool),
        obs_kf=torch.zeros(1, 1, dtype=torch.int64),
        obs_mp=torch.zeros(1, 1, dtype=torch.int64),
        obs_meas=torch.tensor([[[0.075, -0.05]]]),
        obs_sqrt_info=torch.full((1, 1), 458.0),
        obs_valid=torch.ones(1, 1, dtype=torch.bool),
        pe_a=torch.zeros(1, 1, dtype=torch.int64),
        pe_b=torch.zeros(1, 1, dtype=torch.int64),
        pe_meas=torch.eye(4)[None, None].clone(),
        pe_sqrt_info=torch.zeros(1, 1, 6, 6),
        pe_valid=torch.zeros(1, 1, dtype=torch.bool),
        pr_idx=torch.zeros(1, 1, dtype=torch.int64),
        pr_meas=torch.eye(4)[None, None].clone(),
        pr_sqrt_info=torch.zeros(1, 1, 6, 6),
        pr_valid=torch.zeros(1, 1, dtype=torch.bool))
    _, _, J_pt, _, _ = tba._reproj_terms(p.poses, p.points, p, 1e9)
    Hp = (J_pt[0, 0].T @ J_pt[0, 0]).double().numpy()
    assert np.linalg.matrix_rank(Hp, tol=1e-6 * np.abs(Hp).max()) == 2
