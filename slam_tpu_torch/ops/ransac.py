"""Two-view geometry and many-hypothesis RANSAC (port of
slam_tpu/ops/ransac.py): ``triangulate_two_view_jax``, the device Sim3/rot-z
RANSAC of the interactive loop closer, the host NumPy twin that
``DeviceSlam``'s consumer runs, and the essential-matrix 8-point RANSAC
with its pose recovery.

The device RANSACs solve all K hypotheses at once (closed-form Horn with a
batched 4x4 ``eigh``, reference: loop_ransac.cpp:112-196, 277-312; the
8-point nullspace from a batched 9x9 ``eigh`` and the rank-2 projection from
a batched 3x3 SVD, essential_solver.cc:87-118) and score every hypothesis
with one batched pass, then take the argmax (replacing the loops at
loop_ransac.cpp:67-105 and essential_solver.cc:11-85). Their cores take an
explicit hypothesis bank of match indices and any leading batch dimensions;
the default bank is drawn by a ``torch.Generator`` on the device, seeded
per solve.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ops import camera as camera_ops

CHI_SQ_2D = 9.21034  # p=0.01, loop_ransac.cpp:28


def triangulate_two_view(R_21, t_21, b1, b2):
    """Batched two-view midpoint triangulation.

    ``R_21`` (..., 3, 3), ``t_21`` (..., 3): pose of camera 1 in camera 2
    (p2 = R21 p1 + t21); ``b1, b2``: (..., N, 3) bearings. Returns (..., N,
    3) points in camera-1 coordinates and an (..., N) front-of-both-cameras
    mask."""
    c2 = -torch.einsum("...ji,...j->...i", R_21, t_21)         # -R21^T t21
    d1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True),
                          min=1e-12)
    d2 = b2 @ R_21
    d2 = d2 / torch.clamp(torch.linalg.norm(d2, dim=-1, keepdim=True),
                          min=1e-12)
    eye = torch.eye(3, dtype=b1.dtype, device=b1.device)
    M1 = eye - d1[..., :, None] * d1[..., None, :]
    M2 = eye - d2[..., :, None] * d2[..., None, :]
    A = M1 + M2
    rhs = torch.einsum("...nij,...j->...ni", M2, c2)
    # damped solve keeps parallel-ray systems finite; the cheirality and
    # parallax test below masks them
    pts = torch.linalg.solve_ex(A + 1e-6 * eye, rhs[..., None])[0][..., 0]
    z1 = torch.sum(pts * d1, dim=-1)
    z2 = torch.sum((pts - c2[..., None, :]) * d2, dim=-1)
    parallax = torch.sum(d1 * d2, dim=-1)
    ok = (z1 > 1e-6) & (z2 > 1e-6) & (parallax < 1.0 - 1e-7)
    return pts, ok


class Sim3RansacResult(NamedTuple):
    ok: bool
    rot_12: np.ndarray
    trans_12: np.ndarray
    scale_12: float
    inliers: np.ndarray          # (N,) bool over match list
    num_inliers: int


def compute_sim3(pts_1: torch.Tensor, pts_2: torch.Tensor):
    """Horn closed-form absolute orientation with scale, batched.

    ``pts_1``, ``pts_2``: (..., 3, 3) whose COLUMNS are corresponding points
    (the reference's layout, loop_ransac.cpp:112-196). Returns (rot_21,
    trans_21, scale_21) with p2 = s * R @ p1 + t. The eigenvector's sign is
    free, and R is quadratic in it."""
    c1 = pts_1.mean(dim=-1)
    c2 = pts_2.mean(dim=-1)
    a1 = pts_1 - c1[..., None]
    a2 = pts_2 - c2[..., None]
    M = a1 @ a2.transpose(-1, -2)
    sxx, sxy, sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    syx, syy, syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    szx, szy, szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], dim=-2)
    # N is symmetric: the unit quaternion maximizing the form is the
    # eigenvector of the largest eigenvalue (ascending order)
    _, vecs = torch.linalg.eigh(N)
    q = vecs[..., :, -1]                                  # (w, x, y, z)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], dim=-2)
    a1_in_2 = R @ a1
    s = torch.sum(a2 * a1_in_2, dim=(-2, -1)) / torch.sum(a1 * a1,
                                                          dim=(-2, -1))
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return R, t, s


def compute_rot_z(pts_1: torch.Tensor, pts_2: torch.Tensor):
    """Planar (yaw-only) Horn variant, batched (reference:
    loop_ransac.cpp:277-312)."""
    c1 = pts_1.mean(dim=-1)
    c2 = pts_2.mean(dim=-1)
    a1 = pts_1 - c1[..., None]
    a2 = pts_2 - c2[..., None]
    C = torch.sum(a1[..., :2, :] * a2[..., :2, :], dim=(-2, -1))
    S = torch.sum(a1[..., 0, :] * a2[..., 1, :] - a1[..., 1, :] * a2[..., 0, :],
                  dim=-1)
    norm = torch.sqrt(C * C + S * S)
    ct, st = C / norm, S / norm
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    R = torch.stack([torch.stack([ct, -st, zero], -1),
                     torch.stack([st, ct, zero], -1),
                     torch.stack([zero, zero, one], -1)], dim=-2)
    s = torch.sum(a2 * (R @ a1), dim=(-2, -1)) / torch.sum(a1 * a1,
                                                           dim=(-2, -1))
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return R, t, s


def sample_hypotheses(valid: torch.Tensor, iterations: int, seed: int,
                      size: int = 3) -> torch.Tensor:
    """(..., K, size) int64 bank of ``size`` distinct indices among the
    valid matches per hypothesis (weights 0 for padding), for ``valid``
    (..., N), from a generator on ``valid``'s device seeded with ``seed``."""
    gen = torch.Generator(device=valid.device)
    gen.manual_seed(int(seed))
    lead, n = valid.shape[:-1], valid.shape[-1]
    weights = valid.to(torch.float32).reshape(-1, 1, n).expand(
        -1, int(iterations), n).reshape(-1, n)
    idx = torch.multinomial(weights, size, replacement=False, generator=gen)
    return idx.reshape(lead + (int(iterations), size))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, C), idx (..., K, J) -> (..., K, J, C): the rows of each
    hypothesis, for any leading batch dimensions."""
    return torch.take_along_dim(x[..., None, :, :], idx[..., None], dim=-2)


def _take_best(scores: torch.Tensor, *xs):
    """The first maximum of ``scores`` (..., K) and the matching rows of
    each (..., K, ...) tensor in ``xs``."""
    best = torch.argmax(scores, dim=-1, keepdim=True)
    out = [torch.take_along_dim(scores, best, dim=-1)[..., 0]]
    for x in xs:
        b = best.reshape(best.shape + (1,) * (x.dim() - best.dim()))
        out.append(torch.take_along_dim(x, b, dim=best.dim() - 1)
                   .squeeze(best.dim() - 1))
    return out


def sim3_ransac_core(idx, pts1, pts2, valid, repro1, repro2, vis1, vis2,
                     chi1, chi2, kind1, params1, kind2, params2,
                     dof: str, fix_scale: bool):
    """Every hypothesis of the (..., K, 3) index bank ``idx`` at once: Horn
    solves, the symmetric chi2-gated reprojection inlier count
    (loop_ransac.cpp:198-254), argmax winner (the first on a tie). Point
    tensors are (..., N, ...). Returns (count, R12, t12, s12, inliers) as
    tensors on the device."""
    s1 = gather_rows(pts1, idx).transpose(-1, -2)    # (..., K, 3, 3) columns
    s2 = gather_rows(pts2, idx).transpose(-1, -2)
    solver = compute_rot_z if dof == "ZROT" else compute_sim3
    R21, t21, s21 = solver(s1, s2)
    if fix_scale:
        s21 = torch.ones_like(s21)
    s12 = 1.0 / s21
    R12 = R21.transpose(-1, -2)
    t12 = -s12[..., None] * torch.einsum("...kij,...kj->...ki", R12, t21)

    # project pts1 into cam2 under (s21 R21, t21) and pts2 into cam1 under
    # (s12 R12, t12)
    p1_in_2 = (torch.einsum("...kij,...nj->...kni", R21 * s21[..., None, None],
                            pts1) + t21[..., None, :])      # (..., K, N, 3)
    p2_in_1 = (torch.einsum("...kij,...nj->...kni", R12 * s12[..., None, None],
                            pts2) + t12[..., None, :])
    proj1_in_2, v12 = camera_ops.project(kind2, params2, p1_in_2)
    proj2_in_1, v21 = camera_ops.project(kind1, params1, p2_in_1)
    err2 = torch.sum((proj1_in_2 - repro2[..., None, :, :]) ** 2, dim=-1)
    err1 = torch.sum((proj2_in_1 - repro1[..., None, :, :]) ** 2, dim=-1)
    e = lambda x: x[..., None, :]
    ok = (e(valid) & e(vis1) & e(vis2) & v12 & v21
          & (err2 < e(chi2)) & (err1 < e(chi1)))
    counts = torch.sum(ok, dim=-1)                   # (..., K)
    return _take_best(counts, R12, t12, s12, ok)


class Sim3Ransac:
    """Equivalent of the reference ``LoopRansac`` (loop_ransac.hpp:27-109)
    on ``device``.

    Construct with camera-frame 3D correspondences; ``solve`` evaluates all
    hypotheses in parallel. The match axis is padded to a multiple of 64
    (padding has zero sampling weight and is excluded from the counts), as
    in the JAX package, so the sampler sees the same weights."""

    CHI_SQ_2D = CHI_SQ_2D

    def __init__(self, camera1, camera2, pts1_cam, pts2_cam,
                 sigma_sq1, sigma_sq2, device="cuda"):
        self.device = torch.device(device)
        self.n = len(pts1_cam)
        n_pad = max(64, -(-self.n // 64) * 64)
        self.valid = np.arange(n_pad) < self.n

        def _pad(a, fill=0.0):
            a = np.asarray(a)
            out = np.full((n_pad,) + a.shape[1:], fill, a.dtype)
            out[:self.n] = a
            return out

        self.kind1, self.params1 = camera_ops.pack_camera(camera1)
        self.kind2, self.params2 = camera_ops.pack_camera(camera2)
        self.pts1 = _pad(np.asarray(pts1_cam, np.float32).reshape(self.n, 3))
        self.pts2 = _pad(np.asarray(pts2_cam, np.float32).reshape(self.n, 3))
        self.chi1 = _pad((CHI_SQ_2D
                          * np.asarray(sigma_sq1)).astype(np.float32))
        self.chi2 = _pad((CHI_SQ_2D
                          * np.asarray(sigma_sq2)).astype(np.float32))
        # projections of each point into its own camera (loop_ransac.cpp:43-44)
        pts1 = self.pts1[:self.n]
        pts2 = self.pts2[:self.n]
        r1, v1 = camera1.ray_to_pixel(pts1)
        v1 &= camera1.is_valid_pixel(r1)
        r2, v2 = camera2.ray_to_pixel(pts2)
        v2 &= camera2.is_valid_pixel(r2)
        self.repro1 = _pad(np.nan_to_num(r1).astype(np.float32))
        self.repro2 = _pad(np.nan_to_num(r2).astype(np.float32))
        self.vis1 = _pad(v1, fill=False)
        self.vis2 = _pad(v2, fill=False)

    def solve(self, iterations: int, dof: str = "SIM3", fix_scale: bool = False,
              min_inliers: int = 20, seed: int = 94235682) -> Sim3RansacResult:
        if self.n < 3 or self.n < min_inliers:
            return Sim3RansacResult(False, np.eye(3), np.zeros(3), 1.0,
                                    np.zeros(self.n, bool), 0)
        from slam_tpu_torch.precision import pin_full_f32

        pin_full_f32()
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        valid = put(self.valid)
        idx = sample_hypotheses(valid, int(iterations), seed)
        out = sim3_ransac_core(
            idx, put(self.pts1), put(self.pts2), valid, put(self.repro1),
            put(self.repro2), put(self.vis1), put(self.vis2), put(self.chi1),
            put(self.chi2), self.kind1, put(self.params1), self.kind2,
            put(self.params2), dof, bool(fix_scale))
        count, R12, t12, s12, inl = (t.cpu().numpy() for t in out)
        ok = int(count) >= min_inliers
        return Sim3RansacResult(ok, R12.astype(np.float64),
                                t12.astype(np.float64), float(s12),
                                inl[:self.n], int(count))


def _horn_sim3_np(s1: np.ndarray, s2: np.ndarray):
    """Batched Horn absolute orientation, NumPy (K hypotheses at once).

    ``s1, s2``: (K, 3, 3) with COLUMNS as corresponding points (reference:
    loop_ransac.cpp:112-196), vectorized over the hypothesis axis with one
    batched symmetric 4x4 eigendecomposition."""
    c1 = s1.mean(axis=2)
    c2 = s2.mean(axis=2)
    a1 = s1 - c1[:, :, None]
    a2 = s2 - c2[:, :, None]
    M = a1 @ a2.transpose(0, 2, 1)                        # (K, 3, 3)
    sxx, sxy, sxz = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    syx, syy, syz = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    szx, szy, szz = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    K = len(s1)
    N = np.empty((K, 4, 4), s1.dtype)
    N[:, 0, 0] = sxx + syy + szz
    N[:, 0, 1] = N[:, 1, 0] = syz - szy
    N[:, 0, 2] = N[:, 2, 0] = szx - sxz
    N[:, 0, 3] = N[:, 3, 0] = sxy - syx
    N[:, 1, 1] = sxx - syy - szz
    N[:, 1, 2] = N[:, 2, 1] = sxy + syx
    N[:, 1, 3] = N[:, 3, 1] = szx + sxz
    N[:, 2, 2] = -sxx + syy - szz
    N[:, 2, 3] = N[:, 3, 2] = syz + szy
    N[:, 3, 3] = -sxx - syy + szz
    _, vecs = np.linalg.eigh(N)
    q = vecs[:, :, -1]                                    # (K, 4) (w, x, y, z)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((K, 3, 3), s1.dtype)
    R[:, 0, 0] = 1 - 2 * (qy * qy + qz * qz)
    R[:, 0, 1] = 2 * (qx * qy - qz * qw)
    R[:, 0, 2] = 2 * (qx * qz + qy * qw)
    R[:, 1, 0] = 2 * (qx * qy + qz * qw)
    R[:, 1, 1] = 1 - 2 * (qx * qx + qz * qz)
    R[:, 1, 2] = 2 * (qy * qz - qx * qw)
    R[:, 2, 0] = 2 * (qx * qz - qy * qw)
    R[:, 2, 1] = 2 * (qy * qz + qx * qw)
    R[:, 2, 2] = 1 - 2 * (qx * qx + qy * qy)
    a1_in_2 = R @ a1
    s = (np.sum(a2 * a1_in_2, axis=(1, 2))
         / np.maximum(np.sum(a1 * a1, axis=(1, 2)), 1e-12))
    t = c2 - s[:, None] * (R @ c1[:, :, None])[:, :, 0]
    return R, t, s


def _horn_rot_z_np(s1: np.ndarray, s2: np.ndarray):
    """Batched planar (yaw-only) Horn, NumPy (reference:
    loop_ransac.cpp:277-312)."""
    c1 = s1.mean(axis=2)
    c2 = s2.mean(axis=2)
    a1 = s1 - c1[:, :, None]
    a2 = s2 - c2[:, :, None]
    C = np.sum(a1[:, :2] * a2[:, :2], axis=(1, 2))
    S = np.sum(a1[:, 0] * a2[:, 1] - a1[:, 1] * a2[:, 0], axis=1)
    norm = np.maximum(np.sqrt(C * C + S * S), 1e-12)
    ct, st = C / norm, S / norm
    K = len(s1)
    R = np.zeros((K, 3, 3), s1.dtype)
    R[:, 0, 0] = ct
    R[:, 0, 1] = -st
    R[:, 1, 0] = st
    R[:, 1, 1] = ct
    R[:, 2, 2] = 1.0
    s = (np.sum(a2 * (R @ a1), axis=(1, 2))
         / np.maximum(np.sum(a1 * a1, axis=(1, 2)), 1e-12))
    t = c2 - s[:, None] * (R @ c1[:, :, None])[:, :, 0]
    return R, t, s


def sim3_ransac_host(camera1, camera2, pts1_cam, pts2_cam,
                     sigma_sq1, sigma_sq2, iterations: int,
                     dof: str = "SIM3", fix_scale: bool = False,
                     min_inliers: int = 20,
                     seed: int = 94235682) -> Sim3RansacResult:
    """Host NumPy Sim3 RANSAC (reference: loop_ransac.cpp:47-110): K Horn
    hypotheses from random distinct triples (NumPy's generator, seeded),
    a symmetric chi2-gated reprojection inlier count, argmax winner. The
    closure consumer's problem is ~200 hypotheses x ~200 points, too small
    to be worth a device dispatch."""
    n = len(pts1_cam)
    if n < 3 or n < min_inliers:
        return Sim3RansacResult(False, np.eye(3), np.zeros(3), 1.0,
                                np.zeros(n, bool), 0)
    pts1 = np.asarray(pts1_cam, np.float64).reshape(n, 3)
    pts2 = np.asarray(pts2_cam, np.float64).reshape(n, 3)
    chi1 = CHI_SQ_2D * np.asarray(sigma_sq1, np.float64)
    chi2 = CHI_SQ_2D * np.asarray(sigma_sq2, np.float64)
    repro1, vis1 = camera1.ray_to_pixel(pts1)
    vis1 = vis1 & camera1.is_valid_pixel(repro1)
    repro2, vis2 = camera2.ray_to_pixel(pts2)
    vis2 = vis2 & camera2.is_valid_pixel(repro2)
    repro1 = np.nan_to_num(repro1)
    repro2 = np.nan_to_num(repro2)

    rng = np.random.default_rng(seed)
    keys = rng.random((int(iterations), n))
    idx = np.argpartition(keys, 2, axis=1)[:, :3]         # 3 distinct indices
    s1 = pts1[idx].transpose(0, 2, 1)                     # (K, 3, 3) columns
    s2 = pts2[idx].transpose(0, 2, 1)

    solver = _horn_rot_z_np if dof == "ZROT" else _horn_sim3_np
    R21, t21, s21 = solver(s1, s2)
    if fix_scale:
        s21 = np.ones_like(s21)
    s12 = 1.0 / np.where(np.abs(s21) > 1e-12, s21, 1e-12)
    R12 = R21.transpose(0, 2, 1)
    t12 = -s12[:, None] * (R12 @ t21[:, :, None])[:, :, 0]

    K = len(R21)
    # batched BLAS matmuls, not einsum: p @ (sR)^T per hypothesis
    p1_in_2 = (pts1[None] @ (R21 * s21[:, None, None]).transpose(0, 2, 1)
               + t21[:, None, :])                          # (K, N, 3)
    p2_in_1 = (pts2[None] @ (R12 * s12[:, None, None]).transpose(0, 2, 1)
               + t12[:, None, :])
    proj1_in_2, v12 = camera2.ray_to_pixel(p1_in_2.reshape(-1, 3))
    proj2_in_1, v21 = camera1.ray_to_pixel(p2_in_1.reshape(-1, 3))
    err2 = np.sum((np.nan_to_num(proj1_in_2).reshape(K, n, 2)
                   - repro2[None]) ** 2, axis=-1)
    err1 = np.sum((np.nan_to_num(proj2_in_1).reshape(K, n, 2)
                   - repro1[None]) ** 2, axis=-1)
    ok = (vis1[None] & vis2[None]
          & v12.reshape(K, n) & v21.reshape(K, n)
          & (err2 < chi2[None]) & (err1 < chi1[None]))
    counts = ok.sum(axis=1)
    best = int(np.argmax(counts))
    num = int(counts[best])
    return Sim3RansacResult(num >= min_inliers, R12[best], t12[best],
                            float(s12[best]), ok[best], num)


# ---------------------------------------------------------------------------
# Essential matrix: 8-point solver + RANSAC
# ---------------------------------------------------------------------------

ESSENTIAL_RESIDUAL_COS_THR = 0.01745240643  # 1 degree, essential_solver.cc:174
_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def compute_E_8pt(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Essential matrix from >= 8 bearing pairs (..., N, 3), batched
    (reference: essential_solver.cc:87-118): the nullspace of the stacked
    constraint matrix from a 9x9 ``eigh``, then the rank-2 projection from a
    3x3 SVD. Its sign is free."""
    A = torch.cat([b2[..., 0:1] * b1, b2[..., 1:2] * b1, b2[..., 2:3] * b1],
                  dim=-1)                                   # (..., N, 9)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    E_init = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    U, s, Vh = torch.linalg.svd(E_init)
    s = s * torch.tensor([1.0, 1.0, 0.0], dtype=s.dtype, device=s.device)
    return (U * s[..., None, :]) @ Vh


def _essential_residuals(E_21: torch.Tensor, b1: torch.Tensor,
                         b2: torch.Tensor):
    """Symmetric epipolar cosine residuals (essential_solver.cc:164-215) of
    E_21 (..., 3, 3) over bearings (..., N, 3): ((..., N), (..., N))."""
    ep2 = b1 @ E_21.transpose(-1, -2)          # epiplane of each b1 in cam2
    r2 = torch.abs(torch.sum(ep2 * b2, dim=-1)) / torch.clamp(
        torch.linalg.norm(ep2, dim=-1), min=1e-12)
    ep1 = b2 @ E_21                             # E_12 = E_21^T
    r1 = torch.abs(torch.sum(ep1 * b1, dim=-1)) / torch.clamp(
        torch.linalg.norm(ep1, dim=-1), min=1e-12)
    return r1, r2


def essential_ransac_core(idx: torch.Tensor, b1: torch.Tensor,
                          b2: torch.Tensor, valid: torch.Tensor):
    """Every hypothesis of the (..., K, 8) index bank ``idx`` at once over
    bearings (..., N, 3) and match validity (..., N): 8-point solves, the
    symmetric cosine score (the sum of r1 + r2 over a hypothesis's
    inliers), argmax winner (the first on a tie). Returns (E_21, score,
    inliers)."""
    Es = compute_E_8pt(gather_rows(b1, idx), gather_rows(b2, idx))
    r1, r2 = _essential_residuals(Es, b1[..., None, :, :], b2[..., None, :, :])
    inl = ((r1 < ESSENTIAL_RESIDUAL_COS_THR) & (r2 < ESSENTIAL_RESIDUAL_COS_THR)
           & valid[..., None, :])                           # (..., K, N)
    scores = torch.sum(torch.where(inl, r1 + r2, torch.zeros_like(r1)), dim=-1)
    score, E, inliers = _take_best(scores, Es, inl)
    return E, score, inliers


def decompose_E_device(E_21: torch.Tensor):
    """E_21 (..., 3, 3) -> the 4 candidate (R, t): ((..., 4, 3, 3),
    (..., 4, 3)), on the device (reference: essential_solver.cc:120-147;
    the device twin of :func:`decompose_E`)."""
    U, _, Vh = torch.linalg.svd(E_21)
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    W = torch.tensor(_W, dtype=E_21.dtype, device=E_21.device)

    def proper(R):
        neg = torch.linalg.det(R) < 0
        return torch.where(neg[..., None, None], -R, R)
    R1 = proper(U @ W @ Vh)
    R2 = proper(U @ W.T @ Vh)
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def recover_pose_from_E(E_21: torch.Tensor, b1: torch.Tensor,
                        b2: torch.Tensor, valid: torch.Tensor):
    """The (R, t) of the 4 decompositions of E_21 (..., 3, 3) with the most
    valid points in front of both cameras (the first on a tie; reference:
    essential_solver.cc pose recovery via check_inliers on each candidate),
    over bearings (..., N, 3). Returns (R_21, t_21, pts_cam1, ok)."""
    Rs, ts = decompose_E_device(E_21)
    pts4, ok4 = triangulate_two_view(Rs, ts, b1[..., None, :, :],
                                     b2[..., None, :, :])
    counts = torch.sum(ok4 & valid[..., None, :], dim=-1)   # (..., 4)
    _, R, t, pts, ok = _take_best(counts, Rs, ts, pts4, ok4)
    return R, t, pts, ok & valid


class EssentialRansacResult(NamedTuple):
    ok: bool
    E_21: np.ndarray
    inliers: np.ndarray
    score: float


def essential_ransac(bearings_1: np.ndarray, bearings_2: np.ndarray,
                     iterations: int = 100, seed: int = 94235682,
                     recompute: bool = True,
                     device="cuda") -> EssentialRansacResult:
    """Find E_21 by RANSAC over bearing correspondences on ``device``
    (reference: essential_solver.cc:11-85), then refit it on every inlier
    in float64 NumPy on the host."""
    from slam_tpu_torch.precision import pin_full_f32

    n = len(bearings_1)
    if n < 8:
        return EssentialRansacResult(False, np.eye(3), np.zeros(n, bool), 0.0)
    pin_full_f32()
    put = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    b1, b2 = put(bearings_1), put(bearings_2)
    valid = torch.ones(n, dtype=torch.bool, device=b1.device)
    idx = sample_hypotheses(valid, int(iterations), seed, 8)
    E, score, inl = (t.cpu().numpy()
                     for t in essential_ransac_core(idx, b1, b2, valid))
    num = int(inl.sum())
    ok = (float(score) > 0.0) and num >= 8
    if ok and recompute:
        # final all-inlier refit in f64 on host: one 9x9 eigh + 3x3 SVD
        # (essential_solver.cc:71-84)
        s1 = np.asarray(bearings_1, np.float64)[inl]
        s2 = np.asarray(bearings_2, np.float64)[inl]
        A = np.concatenate([s2[:, 0:1] * s1, s2[:, 1:2] * s1,
                            s2[:, 2:3] * s1], axis=1)
        _, vecs = np.linalg.eigh(A.T @ A)
        U, s, Vt = np.linalg.svd(vecs[:, 0].reshape(3, 3))
        s[2] = 0.0
        E = (U * s[None, :]) @ Vt
        ep2 = np.asarray(bearings_1) @ E.T
        r2 = np.abs(np.sum(ep2 * bearings_2, axis=1)) / np.maximum(
            np.linalg.norm(ep2, axis=1), 1e-12)
        ep1 = np.asarray(bearings_2) @ E
        r1 = np.abs(np.sum(ep1 * bearings_1, axis=1)) / np.maximum(
            np.linalg.norm(ep1, axis=1), 1e-12)
        inl = ((r1 < ESSENTIAL_RESIDUAL_COS_THR)
               & (r2 < ESSENTIAL_RESIDUAL_COS_THR))
    return EssentialRansacResult(ok, np.asarray(E, np.float64),
                                 np.asarray(inl), float(score))


def decompose_E(E_21: np.ndarray):
    """E -> 4 candidate (R, t) pairs on the host (reference:
    essential_solver.cc:120-147)."""
    U, _, Vt = np.linalg.svd(E_21)
    t = U[:, 2]
    t = t / np.linalg.norm(t)
    W = np.array(_W)
    R1 = U @ W @ Vt
    if np.linalg.det(R1) < 0:
        R1 = -R1
    R2 = U @ W.T @ Vt
    if np.linalg.det(R2) < 0:
        R2 = -R2
    return [R1, R1, R2, R2], [t, -t, t, -t]
