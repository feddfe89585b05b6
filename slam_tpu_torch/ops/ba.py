"""Bundle adjustment: Levenberg-Marquardt with a dense Schur solve (port of
slam_tpu/ops/ba.py, the branch the device VO's window BA runs).

Residuals are whitened normalized-camera reprojection edges (Huber,
delta = sqrt(5.991)), SE3 odometry edges with EdgeSE3Expmap error
log(est_b^-1 * meas * est_a), and unary SE3 priors. Normal-equation blocks
are assembled with ``index_add_`` segment sums; landmarks are eliminated by
forming the (6K, 6K) reduced camera system densely. Updates are
left-multiplicative. Every tensor of a :class:`BAProblem` carries a leading
batch dimension S (one independent problem per sequence).

The implicit-Schur PCG branch of the JAX solver (``cg_iters > 0``) serves
problems larger than ``DENSE_SCHUR_MAX_KM`` and is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from slam_tpu_torch.ops import lie

CHI2_THRESHOLD = 5.991  # reference: bundle_adjuster.cpp:28
DENSE_SCHUR_MAX_KM = 1 << 20


class BAProblem(NamedTuple):
    poses: torch.Tensor        # (S, K, 4, 4) f32 world-to-camera
    pose_fixed: torch.Tensor   # (S, K) bool
    points: torch.Tensor       # (S, M, 3) f32
    points_fixed: torch.Tensor # (S, M) bool
    obs_kf: torch.Tensor       # (S, O) int64
    obs_mp: torch.Tensor       # (S, O) int64
    obs_meas: torch.Tensor     # (S, O, 2) f32 normalized-camera measurement
    obs_sqrt_info: torch.Tensor  # (S, O) f32 (focal / sigma_level)
    obs_valid: torch.Tensor    # (S, O) bool
    pe_a: torch.Tensor         # (S, E) int64 vertex0 index
    pe_b: torch.Tensor         # (S, E) int64 vertex1 index
    pe_meas: torch.Tensor      # (S, E, 4, 4) f32
    pe_sqrt_info: torch.Tensor # (S, E, 6, 6) f32
    pe_valid: torch.Tensor     # (S, E) bool
    pr_idx: torch.Tensor       # (S, P) int64 unary-prior pose index
    pr_meas: torch.Tensor      # (S, P, 4, 4) f32 target pose
    pr_sqrt_info: torch.Tensor # (S, P, 6, 6) f32
    pr_valid: torch.Tensor     # (S, P) bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    obs_chi2: torch.Tensor     # (S, O) final unweighted chi2 per observation
    cost: torch.Tensor         # (S,) robust cost


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: x (S, R, ...), idx (S, N) -> (S, N, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def segment_sum(values: torch.Tensor, idx: torch.Tensor, num: int):
    """Batched segment sum: values (S, O, ...), idx (S, O) in [0, num) ->
    (S, num, ...)."""
    S, O = idx.shape
    flat = (idx + torch.arange(S, device=idx.device)[:, None] * num).reshape(-1)
    out = values.new_zeros((S * num,) + values.shape[2:])
    out.index_add_(0, flat, values.reshape((S * O,) + values.shape[2:]))
    return out.reshape((S, num) + values.shape[2:])


def _where(mask, a, b):
    """torch.where with ``mask`` broadcast over trailing dims of ``a``."""
    mask = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(mask, a, b)


def _reproj_terms(poses, points, p: BAProblem, huber_delta):
    """Residuals, Jacobians and Huber weights of all reprojection edges."""
    T = take(poses, p.obs_kf)                          # (S, O, 4, 4)
    X = take(points, p.obs_mp)                         # (S, O, 3)
    pc = torch.einsum("soij,soj->soi", T[..., :3, :3], X) + T[..., :3, 3]
    z = pc[..., 2]
    zsafe = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
    pred = pc[..., :2] / zsafe[..., None]
    r = (pred - p.obs_meas) * p.obs_sqrt_info[..., None]
    chi2 = torch.sum(r * r, dim=-1)
    rnorm = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w = torch.clamp(huber_delta / rnorm, max=1.0)
    w = torch.where(p.obs_valid, w, torch.zeros_like(w))

    inv_z = 1.0 / zsafe
    zero = torch.zeros_like(z)
    Jproj = torch.stack([
        torch.stack([inv_z, zero, -pc[..., 0] * inv_z * inv_z], dim=-1),
        torch.stack([zero, inv_z, -pc[..., 1] * inv_z * inv_z], dim=-1),
    ], dim=-2)                                         # (S, O, 2, 3)
    si = p.obs_sqrt_info[..., None, None]
    sqw = torch.sqrt(w)[..., None, None]
    eye3 = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    Jp_pose = torch.cat([-lie.skew(pc), eye3], dim=-1)  # (S, O, 3, 6)
    J_pose = (Jproj @ Jp_pose) * si * sqw
    J_pt = (Jproj @ T[..., :3, :3]) * si * sqw
    J_pose = _where(take(p.pose_fixed, p.obs_kf), torch.zeros_like(J_pose),
                    J_pose)
    J_pt = _where(take(p.points_fixed, p.obs_mp), torch.zeros_like(J_pt),
                  J_pt)
    r_w = r * torch.sqrt(w)[..., None]
    chi2 = torch.where(p.obs_valid, chi2, torch.zeros_like(chi2))
    return r_w, J_pose, J_pt, chi2, w


def _pe_error_fn(xi_a, xi_b, Ta, Tb, C):
    """EdgeSE3Expmap error with left-mult tangents applied to both
    vertices."""
    A = lie.se3_exp(xi_a) @ Ta
    B = lie.se3_exp(xi_b) @ Tb
    return lie.se3_log(lie.se3_inverse(B) @ C @ A)


def _flat(x, lead):
    return x.reshape((-1,) + x.shape[lead:])


def _pose_edge_terms(poses, p: BAProblem, jacobians: bool = True):
    """Whitened odometry-edge residuals (S, E, 6) and, when asked, their
    Jacobians with respect to both vertices (zero for fixed vertices)."""
    S, E = p.pe_a.shape
    zero = poses.new_zeros(S * E, 6)
    Ta = _flat(take(poses, p.pe_a), 2)
    Tb = _flat(take(poses, p.pe_b), 2)
    C = _flat(p.pe_meas, 2)
    Si = _flat(p.pe_sqrt_info, 2)
    e0 = _pe_error_fn(zero, zero, Ta, Tb, C)
    r = (Si @ e0[..., None])[..., 0].reshape(S, E, 6)
    r = _where(p.pe_valid, r, torch.zeros_like(r))
    if not jacobians:
        return r, None, None
    Ja = lie.batched_jacfwd(lambda xa: _pe_error_fn(xa, zero, Ta, Tb, C), zero)
    Jb = lie.batched_jacfwd(lambda xb: _pe_error_fn(zero, xb, Ta, Tb, C), zero)
    Ja = (Si @ Ja).reshape(S, E, 6, 6)
    Jb = (Si @ Jb).reshape(S, E, 6, 6)
    Ja = _where(p.pe_valid & ~take(p.pose_fixed, p.pe_a), Ja,
                torch.zeros_like(Ja))
    Jb = _where(p.pe_valid & ~take(p.pose_fixed, p.pe_b), Jb,
                torch.zeros_like(Jb))
    return r, Ja, Jb


def _prior_error_fn(xi, T, P0):
    return lie.se3_log(lie.se3_inverse(lie.se3_exp(xi) @ T) @ P0)


def _prior_terms(poses, p: BAProblem, jacobians: bool = True):
    """Whitened unary-prior residuals (S, P, 6) and, when asked, their
    Jacobians (zero for fixed poses)."""
    S, P = p.pr_idx.shape
    zero = poses.new_zeros(S * P, 6)
    T = _flat(take(poses, p.pr_idx), 2)
    P0 = _flat(p.pr_meas, 2)
    Si = _flat(p.pr_sqrt_info, 2)
    e0 = _prior_error_fn(zero, T, P0)
    r = (Si @ e0[..., None])[..., 0].reshape(S, P, 6)
    r = _where(p.pr_valid, r, torch.zeros_like(r))
    if not jacobians:
        return r, None
    J = (Si @ lie.batched_jacfwd(_prior_error_fn, zero, T, P0)).reshape(
        S, P, 6, 6)
    ok = p.pr_valid & ~take(p.pose_fixed, p.pr_idx)
    J = _where(ok, J, torch.zeros_like(J))
    return r, J


def robust_cost(chi2, huber_delta):
    """g2o Huber rho(chi2)."""
    d2 = huber_delta * huber_delta
    return torch.where(chi2 <= d2, chi2,
                       2.0 * huber_delta * torch.sqrt(torch.clamp(chi2, min=1e-12))
                       - d2)


def _total_cost(poses, points, p: BAProblem, huber_delta):
    T = take(poses, p.obs_kf)
    X = take(points, p.obs_mp)
    pc = torch.einsum("soij,soj->soi", T[..., :3, :3], X) + T[..., :3, 3]
    z = pc[..., 2]
    zsafe = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
    pred = pc[..., :2] / zsafe[..., None]
    r = (pred - p.obs_meas) * p.obs_sqrt_info[..., None]
    chi2 = torch.sum(r * r, dim=-1)
    chi2 = torch.where(p.obs_valid, chi2, torch.zeros_like(chi2))
    cost = torch.sum(robust_cost(chi2, huber_delta) * p.obs_valid, dim=-1)
    r_pe, _, _ = _pose_edge_terms(poses, p, jacobians=False)
    cost = cost + torch.sum(r_pe * r_pe, dim=(-2, -1))
    r_pr, _ = _prior_terms(poses, p, jacobians=False)
    cost = cost + torch.sum(r_pr * r_pr, dim=(-2, -1))
    return cost, chi2


def _linearize_and_solve(poses, points, lam, p: BAProblem, huber_delta):
    """One damped Gauss-Newton step: dense reduced camera system, then
    back-substitution for the points."""
    S, K = poses.shape[:2]
    M = points.shape[1]
    dev, dt = poses.device, poses.dtype

    r_obs, J_pose, J_pt, _, _ = _reproj_terms(poses, points, p, huber_delta)
    r_pe, Ja, Jb = _pose_edge_terms(poses, p)
    r_pr, Jpr = _prior_terms(poses, p)

    Hll = segment_sum(torch.einsum("soci,socj->soij", J_pt, J_pt), p.obs_mp, M)
    bl = segment_sum(-torch.einsum("soci,soc->soi", J_pt, r_obs), p.obs_mp, M)
    Hpp = segment_sum(torch.einsum("soci,socj->soij", J_pose, J_pose),
                      p.obs_kf, K)
    bp = segment_sum(-torch.einsum("soci,soc->soi", J_pose, r_obs), p.obs_kf, K)
    Hpp = Hpp + segment_sum(torch.einsum("seci,secj->seij", Ja, Ja), p.pe_a, K)
    Hpp = Hpp + segment_sum(torch.einsum("seci,secj->seij", Jb, Jb), p.pe_b, K)
    bp = bp + segment_sum(-torch.einsum("seci,sec->sei", Ja, r_pe), p.pe_a, K)
    bp = bp + segment_sum(-torch.einsum("seci,sec->sei", Jb, r_pe), p.pe_b, K)
    Wab = torch.einsum("seci,secj->seij", Ja, Jb)
    Hpp = Hpp + segment_sum(torch.einsum("spci,spcj->spij", Jpr, Jpr),
                            p.pr_idx, K)
    bp = bp + segment_sum(-torch.einsum("spci,spc->spi", Jpr, r_pr),
                          p.pr_idx, K)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    damp = (lam + 1e-8)[:, None, None, None]
    # damping + identity for fixed/empty slots keeps blocks invertible
    Hpp_d = _where(p.pose_fixed, eye6.expand_as(Hpp), Hpp + damp * eye6)
    Hll_d = _where(p.points_fixed, eye3.expand_as(Hll), Hll + damp * eye3)
    Hll_inv = torch.linalg.inv_ex(Hll_d)[0]
    bl = _where(p.points_fixed, torch.zeros_like(bl), bl)
    bp = _where(p.pose_fixed, torch.zeros_like(bp), bp)

    def Hlp_apply(xp):
        contrib = torch.einsum("soci,soi->soc", J_pose, take(xp, p.obs_kf))
        return segment_sum(torch.einsum("soci,soc->soi", J_pt, contrib),
                           p.obs_mp, M)

    def Hpl_apply(xl):
        contrib = torch.einsum("soci,soi->soc", J_pt, take(xl, p.obs_mp))
        return segment_sum(torch.einsum("soci,soc->soi", J_pose, contrib),
                           p.obs_kf, K)

    rhs = bp - Hpl_apply(torch.einsum("smij,smj->smi", Hll_inv, bl))
    rhs = _where(p.pose_fixed, torch.zeros_like(rhs), rhs)

    # dense Schur: the reduced (6K, 6K) camera system, solved directly
    Wkm = segment_sum(torch.einsum("soci,socj->soij", J_pose, J_pt),
                      p.obs_kf * M + p.obs_mp, K * M).reshape(S, K, M, 6, 3)
    Y = torch.einsum("skmij,smjl->skmil", Wkm, Hll_inv)
    Sm = -torch.einsum("skmil,sqmjl->skqij", Y, Wkm)
    Sm = Sm + segment_sum(Wab, p.pe_a * K + p.pe_b, K * K).reshape(S, K, K, 6, 6)
    Sm = Sm + segment_sum(Wab.transpose(-1, -2), p.pe_b * K + p.pe_a,
                          K * K).reshape(S, K, K, 6, 6)
    eyeK = torch.eye(K, dtype=dt, device=dev)[None, :, :, None, None]
    Sm = Sm + eyeK * Hpp_d[:, :, None]
    # fixed poses: identity rows/cols + zero rhs => dx stays 0
    zero = torch.zeros_like(Sm)
    Sm = torch.where(p.pose_fixed[:, :, None, None, None], zero, Sm)
    Sm = torch.where(p.pose_fixed[:, None, :, None, None], zero, Sm)
    Sm = Sm + eyeK * _where(p.pose_fixed, eye6.expand_as(Hpp),
                            torch.zeros_like(Hpp))[:, :, None]
    Sfull = Sm.permute(0, 1, 3, 2, 4).reshape(S, 6 * K, 6 * K)
    dx_p = torch.linalg.solve_ex(Sfull, rhs.reshape(S, 6 * K, 1))[0]
    dx_p = _where(p.pose_fixed, torch.zeros_like(rhs), dx_p.reshape(S, K, 6))
    dx_l = torch.einsum("smij,smj->smi", Hll_inv, bl - Hlp_apply(dx_p))
    dx_l = _where(p.points_fixed, torch.zeros_like(dx_l), dx_l)
    return dx_p, dx_l


def lm_run(p: BAProblem, iterations: int, cg_iters: int,
           huber_delta: float, init_lambda: float) -> BAResult:
    """``iterations`` LM steps with accept/reject and lambda schedule.
    Matmuls must run in full f32 (``slam_tpu_torch/precision.py``)."""
    if cg_iters != 0:
        raise NotImplementedError("the implicit-Schur PCG branch "
                                  "(cg_iters > 0) is not ported")
    S = p.poses.shape[0]
    poses, points = p.poses, p.points
    cost, _ = _total_cost(poses, points, p, huber_delta)
    lam = torch.full((S,), init_lambda, dtype=poses.dtype, device=poses.device)
    for _ in range(iterations):
        dx_p, dx_l = _linearize_and_solve(poses, points, lam, p, huber_delta)
        new_poses = lie.se3_exp(dx_p) @ poses
        new_points = points + dx_l
        new_cost, _ = _total_cost(new_poses, new_points, p, huber_delta)
        accept = new_cost < cost
        poses = _where(accept, new_poses, poses)
        points = _where(accept, new_points, points)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    _, chi2 = _total_cost(poses, points, p, huber_delta)
    return BAResult(poses, points, chi2, cost)


def pick_cg_iters(n_poses_padded: int, n_points_padded: int) -> int:
    """Static solver selection: 0 = dense Schur direct solve, else the PCG
    iteration budget."""
    if n_poses_padded * n_points_padded <= DENSE_SCHUR_MAX_KM:
        return 0
    return min(6 * n_poses_padded, 96)
