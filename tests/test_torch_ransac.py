"""The port's essential-matrix RANSAC (``slam_tpu_torch/ops/ransac.py``)
beside the JAX package's on CPU. ``jax.random`` streams cannot be
reproduced, so the port's core is fed the bank of 8-index hypotheses that
the JAX package draws. ``eigh`` and SVD signs are free: E is compared up
to sign, the four pose candidates as a set; inlier masks, counts and the
chosen candidate are equal.

The 8-point solve runs in f32 through the 9x9 ``eigh`` of A^T A, which
squares the octet's condition number: on a near-degenerate octet the
nullspace is rounding, and the two packages' LAPACKs round it
differently. The reference's score is the sum of the inliers' residuals,
so on noise-free bearings the winner is decided by that rounding too.
The hypothesis-level test therefore holds the well-conditioned octets,
and the whole core is held on bearings with noise (1e-3), where the
residuals, not the rounding, rank the hypotheses.
Also the reference's own checks (tests/test_ransac.py ``TestEssential``) on
the port with its own sampler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.geometry import se3
from slam_tpu.ops import ransac as jransac
from slam_tpu_torch.ops import ransac as transac

torch.set_num_threads(1)
SEED = 94235682


def _scene(n=60, noise=0.0, outliers=0, seed=5):
    rng = np.random.default_rng(seed)
    R2 = se3.so3_exp(np.array([0.02, 0.15, -0.03]))
    c2 = np.array([0.8, 0.1, 0.0])
    t2 = -R2 @ c2
    pts = rng.uniform([-2, -2, 3], [2, 2, 8], (n, 3))
    b1 = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    p2 = pts @ R2.T + t2
    b2 = p2 / np.linalg.norm(p2, axis=1, keepdims=True)
    if noise:
        b1 = b1 + rng.normal(0, noise, b1.shape)
        b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    if outliers:
        b2[:outliers] = rng.normal(size=(outliers, 3))
        b2[:outliers] /= np.linalg.norm(b2[:outliers], axis=1, keepdims=True)
    return b1, b2, R2, t2


def jax_bank(valid, iterations, seed, size=8):
    """The hypothesis bank of the JAX package's ``_essential_ransac_impl``
    (``size`` 8) or ``_sim3_ransac_impl`` (3)."""
    keys = jax.random.split(jax.random.PRNGKey(np.uint32(seed)), iterations)
    p = jnp.asarray(np.asarray(valid), jnp.float32)
    pick = lambda k: jax.random.choice(k, len(p), shape=(size,),
                                       replace=False, p=p / jnp.sum(p))
    return np.asarray(jax.vmap(pick)(keys)).astype(np.int64)


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < atol


def _wide_scene(n, noise, outliers, seed):
    """A two-view scene with a 2 m baseline and bearing noise: every
    hypothesis's residuals come from the noise, not from rounding."""
    rng = np.random.default_rng(seed)
    R2 = se3.so3_exp(np.array([0.05, 0.3, -0.05]))
    t2 = -R2 @ np.array([2.0, 0.3, 0.5])
    pts = rng.uniform([-3, -2, 2], [4, 2, 6], (n, 3))
    b1 = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    p2 = pts @ R2.T + t2
    b2 = p2 / np.linalg.norm(p2, axis=1, keepdims=True)
    b1 = b1 + rng.normal(0, noise, b1.shape)
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    b2[:outliers] = rng.normal(size=(outliers, 3))
    b2[:outliers] /= np.linalg.norm(b2[:outliers], axis=1, keepdims=True)
    return b1.astype(np.float32), b2.astype(np.float32)


def _well_conditioned(b1, b2, bank):
    """Octets whose 8-point nullspace f32 can resolve: the second-smallest
    eigenvalue of A^T A is a thousand f32 ulps of its largest. Elsewhere
    the f32 nullspace is rounding and the two LAPACKs round differently."""
    s1 = b1[bank].astype(np.float64)
    s2 = b2[bank].astype(np.float64)
    A = np.concatenate([s2[..., 0:1] * s1, s2[..., 1:2] * s1,
                        s2[..., 2:3] * s1], axis=-1)
    ev = np.linalg.eigvalsh(np.swapaxes(A, -1, -2) @ A)
    return ev[:, 1] > 1e3 * np.finfo(np.float32).eps * ev[:, -1]


def test_8pt_and_residuals_match_jax_per_hypothesis():
    """Every well-conditioned hypothesis of the reference's scene: E within
    5e-4 up to sign, residuals within 1e-6 where E is, inlier masks equal."""
    b1, b2, _, _ = _scene(n=80, noise=1e-4, outliers=20)
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    bank = jax_bank(np.ones(80, bool), 128, SEED)
    good = _well_conditioned(b1, b2, bank)
    assert good.sum() >= 20
    with jax.default_matmul_precision("highest"):
        jE = np.asarray(jax.jit(jax.vmap(jransac.compute_E_8pt))(
            b1[bank], b2[bank]))
        jr1, jr2 = (np.asarray(x) for x in jax.jit(jax.vmap(
            jransac._essential_residuals, in_axes=(0, None, None)))(
                jE, b1, b2))
    tb1, tb2 = torch.from_numpy(b1), torch.from_numpy(b2)
    E = transac.compute_E_8pt(tb1[bank], tb2[bank]).numpy()
    for g, w in zip(E[good], jE[good]):
        _same_up_to_sign(g, w, 5e-4)
    # the residuals of the JAX package's own E: the same arithmetic
    r1, r2 = transac._essential_residuals(torch.from_numpy(jE), tb1[None],
                                          tb2[None])
    np.testing.assert_allclose(r1.numpy(), jr1, atol=1e-6)
    np.testing.assert_allclose(r2.numpy(), jr2, atol=1e-6)
    thr = transac.ESSENTIAL_RESIDUAL_COS_THR
    t1, t2 = transac._essential_residuals(torch.from_numpy(E), tb1[None],
                                          tb2[None])
    mask = ((t1 < thr) & (t2 < thr)).numpy()
    np.testing.assert_array_equal(mask[good], ((jr1 < thr) & (jr2 < thr))[good])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_core_matches_jax_with_the_jax_bank(seed):
    """The whole core on the JAX bank: the same winner's inliers, E within
    5e-4 up to sign, the score (a sum of about 80 residuals, each moved by
    E's rounding) within 1e-2 relative."""
    n = 100
    b1, b2 = _wide_scene(n, 1e-3, 20, seed)
    valid = np.ones(n, bool)
    valid[::9] = False                        # padding-like holes
    iters = 128
    keys = jax.random.split(jax.random.PRNGKey(np.uint32(SEED + seed)), iters)
    with jax.default_matmul_precision("highest"):
        jE, jscore, jinl = (np.asarray(x) for x in jax.jit(
            jransac._essential_ransac_core)(keys, b1, b2, valid))
    bank = torch.from_numpy(jax_bank(valid, iters, SEED + seed))
    E, score, inl = transac.essential_ransac_core(
        bank, torch.from_numpy(b1), torch.from_numpy(b2),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(inl.numpy(), jinl)
    assert inl.sum() >= 45 and not inl.numpy()[~valid].any()
    _same_up_to_sign(E.numpy(), jE, 5e-4)
    np.testing.assert_allclose(float(score), float(jscore), rtol=1e-2)


def test_essential_ransac_matches_jax_with_the_jax_bank(monkeypatch):
    b1, b2, _, _ = _scene(n=80, noise=1e-4, outliers=20)
    want = jransac.essential_ransac(b1, b2, iterations=200)
    bank = jax_bank(np.ones(80, bool), 200, SEED)
    monkeypatch.setattr(transac, "sample_hypotheses",
                        lambda valid, k, seed, size: torch.from_numpy(bank))
    got = transac.essential_ransac(b1, b2, iterations=200, device="cpu")
    assert got.ok == want.ok
    np.testing.assert_array_equal(got.inliers, want.inliers)
    # the float64 refit on the same inliers
    _same_up_to_sign(got.E_21, want.E_21, 1e-6)
    # the f32 winner's score: a sum of residuals, each moved by E's rounding
    np.testing.assert_allclose(got.score, want.score, rtol=1e-2)


def test_decompose_and_recover_pose_match_jax():
    b1, b2, R2, t2 = _scene(n=60, noise=1e-4, outliers=10)
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    E = (np.cross(np.eye(3), t2) @ R2).astype(np.float32)
    Rs, ts = transac.decompose_E_device(torch.from_numpy(E))
    jRs, jts = (np.asarray(x) for x in jransac.decompose_E_jax(E))
    # as a set: each JAX candidate has a port candidate equal to it
    for jR, jt in zip(jRs, jts):
        assert min(max(np.abs(R - jR).max(), np.abs(t - jt).max())
                   for R, t in zip(Rs.numpy(), ts.numpy())) < 1e-5
    hR, ht = transac.decompose_E(E.astype(np.float64))
    for R, t in zip(hR, ht):
        assert min(max(np.abs(R - jR).max(), np.abs(t - jt).max())
                   for jR, jt in zip(jRs, jts)) < 1e-5
    valid = np.ones(60, bool)
    valid[:5] = False
    R, t, pts, ok = transac.recover_pose_from_E(
        torch.from_numpy(E), torch.from_numpy(b1), torch.from_numpy(b2),
        torch.from_numpy(valid))
    jR, jt, jpts, jok = (np.asarray(x) for x in jransac.recover_pose_from_E_jax(
        E, b1, b2, valid))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(R.numpy(), jR, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), jt, atol=1e-5)
    np.testing.assert_allclose(pts.numpy()[jok], jpts[jok], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(R.numpy(), R2, atol=5e-3)


def test_batched_core_equals_one_by_one():
    scenes = [_scene(n=64, noise=2e-4, outliers=8, seed=s) for s in range(3)]
    b1 = torch.from_numpy(np.stack([s[0] for s in scenes]).astype(np.float32))
    b2 = torch.from_numpy(np.stack([s[1] for s in scenes]).astype(np.float32))
    valid = torch.ones(3, 64, dtype=torch.bool)
    idx = transac.sample_hypotheses(valid, 32, 3, 8)
    assert idx.shape == (3, 32, 8)
    E, score, inl = transac.essential_ransac_core(idx, b1, b2, valid)
    R, t, pts, ok = transac.recover_pose_from_E(E, b1, b2, inl)
    for s in range(3):
        e1, sc1, in1 = transac.essential_ransac_core(idx[s], b1[s], b2[s],
                                                     valid[s])
        np.testing.assert_array_equal(in1.numpy(), inl[s].numpy())
        np.testing.assert_allclose(e1.numpy(), E[s].numpy(), atol=1e-6)
        r1, t1, _, ok1 = transac.recover_pose_from_E(e1, b1[s], b2[s], in1)
        np.testing.assert_array_equal(ok1.numpy(), ok[s].numpy())
        np.testing.assert_allclose(r1.numpy(), R[s].numpy(), atol=1e-6)


def test_own_sampler_draws_distinct_valid_octets():
    valid = torch.arange(100) < 40
    a = transac.sample_hypotheses(valid, 200, 5, 8)
    assert a.shape == (200, 8)
    assert torch.equal(a, transac.sample_hypotheses(valid, 200, 5, 8))
    assert bool((a < 40).all())
    s = torch.sort(a, dim=1).values
    assert bool((s[:, 1:] != s[:, :-1]).all())


# the reference's TestEssential (tests/test_ransac.py:90-135) on the port

def test_8pt_exact():
    b1, b2, R2, t2 = _scene()
    E = transac.compute_E_8pt(torch.from_numpy(b1), torch.from_numpy(b2))
    want = np.cross(np.eye(3), t2) @ R2
    _same_up_to_sign(E.numpy() / np.linalg.norm(E.numpy()),
                     want / np.linalg.norm(want), 1e-4)


def test_ransac_with_outliers():
    b1, b2, R2, t2 = _scene(n=80, noise=1e-4, outliers=20)
    res = transac.essential_ransac(b1, b2, iterations=200, device="cpu")
    assert res.ok
    assert res.inliers[20:].mean() >= 0.85
    assert res.inliers[:20].mean() < 0.3
    rots, transes = transac.decompose_E(res.E_21)
    assert min(np.abs(r - R2).max() for r in rots) < 0.05


def test_too_few_matches():
    b1 = np.random.default_rng(0).normal(size=(5, 3))
    assert not transac.essential_ransac(b1, b1, iterations=10,
                                        device="cpu").ok
