"""Bundle adjustment: Levenberg-Marquardt with a Schur solve (port of
slam_tpu/ops/ba.py).

Residuals are whitened normalized-camera reprojection edges (Huber,
delta = sqrt(5.991)), SE3 odometry edges with EdgeSE3Expmap error
log(est_b^-1 * meas * est_a), and unary SE3 priors. Normal-equation blocks
are assembled with fixed-order segment sums. Landmarks are eliminated
either by forming the (6K, 6K) reduced camera system densely
(``cg_iters == 0``) or implicitly, with PCG on the Schur complement and a
block-Jacobi preconditioner (``cg_iters > 0``, problems above
``DENSE_SCHUR_MAX_KM``). Updates are left-multiplicative. Every tensor of a
:class:`BAProblem` carries a leading batch dimension S (one independent
problem per sequence; the interactive path's solves have S = 1).

The JAX package's single-buffer uint32 transfer (``pack_problem``,
``fuse_packed`` and the ``*_packed``/``*_fused`` entry points) is not
ported: callers build the tensors directly, through pinned memory.

``solve_ba`` and ``solve_ba_two_stage`` are the counterparts of the JAX
package's jitted entry points: one program per padded bucket
(:data:`BA_GRAPHS`, one CUDA graph a bucket on a card). Their op-by-op
twins, ``solve_ba_eager`` and ``solve_ba_two_stage_eager``, are what the
first call of a bucket runs, unless a larger held bucket covers it: then
that bucket solves it, padded by the rule the problem builder pads by
(``PADDING``, ``fill_padding``).
"""
from __future__ import annotations

import math
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_tpu_torch.ops import lie
from slam_tpu_torch.ops.graphs import Entry, GraphCache, where
from slam_tpu_torch.precision import pin_full_f32
from slam_tpu_torch.utils import timer

CHI2_THRESHOLD = 5.991  # reference: bundle_adjuster.cpp:28
# Largest padded K*M for which the dense-Schur path builds its (K, M, 6, 3)
# coupling tensor (72 B/pair): 1M pairs = 72 MB. Above this, PCG.
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


# The padding rule of a problem: each field's padded axis (the one after the
# batch axis) and what a padded slot holds. Padded poses are fixed
# identities, padded points fixed at the origin; padded observations, edges
# and priors are invalid, index slot 0 and carry zero information, so they
# add exact zeros to every sum. ``stage2_pose_fixed`` is the two-stage
# solve's stage-2 mask over the poses. A field without an axis here is not
# padded (``anchor_slot``, ``anchor_sqrt_info``).
PADDING = dict(
    poses=("K", "eye"), pose_fixed=("K", True),
    points=("M", 0), points_fixed=("M", True),
    obs_kf=("O", 0), obs_mp=("O", 0), obs_meas=("O", 0),
    obs_sqrt_info=("O", 0), obs_valid=("O", False),
    pe_a=("E", 0), pe_b=("E", 0), pe_meas=("E", "eye"),
    pe_sqrt_info=("E", 0), pe_valid=("E", False),
    pr_idx=("P", 0), pr_meas=("P", "eye"), pr_sqrt_info=("P", 0),
    pr_valid=("P", False),
    stage2_pose_fixed=("K", True))


def fill_padding(t, field: str, start: int) -> None:
    """Write what a padded slot of ``field`` holds into ``t[:, start:]``
    (``t`` a batched tensor or NumPy array, its padded axis second): how
    ``pipeline/bundle_adjustment._ProblemBuilder.build`` pads a problem, and
    how a covering bucket (:func:`_dispatch`) pads a smaller one."""
    tail = t[:, start:]
    fill = PADDING[field][1]
    if fill == "eye":
        if isinstance(tail, torch.Tensor):
            tail.zero_()
            tail.diagonal(dim1=-2, dim2=-1).fill_(1)
        else:
            tail[...] = np.eye(tail.shape[-1], dtype=tail.dtype)
    else:
        tail[...] = fill


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: x (S, R, ...), idx (S, N) -> (S, N, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def segment_sum(values: torch.Tensor, idx: torch.Tensor, num: int):
    """Batched segment sum: values (S, O, ...), idx (S, O) in [0, num) ->
    (S, num, ...), each segment added in a fixed order, so that a solve
    rounds the same way every run. On the card ``index_add_`` adds with
    atomics in no fixed order; ``index_put_(accumulate=True)`` there sorts
    the indices (stable) and adds each segment's rows one after another.
    On the CPU ``index_add_`` adds in row order."""
    S, O = idx.shape
    flat = (idx + torch.arange(S, device=idx.device)[:, None] * num).reshape(-1)
    src = values.reshape((S * O,) + values.shape[2:])
    out = values.new_zeros((S * num,) + values.shape[2:])
    if out.is_cuda:
        out.index_put_((flat,), src, accumulate=True)
    else:
        out.index_add_(0, flat, src)
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


def _pe_error_fn(Ta, Tb, C):
    """EdgeSE3Expmap error log(Tb^-1 C Ta)."""
    return lie.se3_log(lie.se3_inverse(Tb) @ C @ Ta)


def _flat(x, lead):
    return x.reshape((-1,) + x.shape[lead:])


def _pose_edge_terms(poses, p: BAProblem, jacobians: bool = True):
    """Whitened odometry-edge residuals (S, E, 6) and, when asked, their
    Jacobians with respect to both vertices' left-multiplied tangents
    (exact closed forms, ``ops/lie``; zero for fixed vertices)."""
    S, E = p.pe_a.shape
    Ta = _flat(take(poses, p.pe_a), 2)
    Tb = _flat(take(poses, p.pe_b), 2)
    C = _flat(p.pe_meas, 2)
    Si = _flat(p.pe_sqrt_info, 2)
    if jacobians:
        e0, Ja, Jb = lie.edge_error_and_jacobians(Ta, Tb, C)
    else:
        e0 = _pe_error_fn(Ta, Tb, C)
    r = (Si @ e0[..., None])[..., 0].reshape(S, E, 6)
    r = _where(p.pe_valid, r, torch.zeros_like(r))
    if not jacobians:
        return r, None, None
    Ja = (Si @ Ja).reshape(S, E, 6, 6)
    Jb = (Si @ Jb).reshape(S, E, 6, 6)
    Ja = _where(p.pe_valid & ~take(p.pose_fixed, p.pe_a), Ja,
                torch.zeros_like(Ja))
    Jb = _where(p.pe_valid & ~take(p.pose_fixed, p.pe_b), Jb,
                torch.zeros_like(Jb))
    return r, Ja, Jb


def _prior_terms(poses, p: BAProblem, jacobians: bool = True):
    """Whitened unary-prior residuals (S, P, 6) and, when asked, their
    Jacobians (zero for fixed poses)."""
    S, P = p.pr_idx.shape
    T = _flat(take(poses, p.pr_idx), 2)
    P0 = _flat(p.pr_meas, 2)
    Si = _flat(p.pr_sqrt_info, 2)
    if jacobians:
        e0, J = lie.prior_error_and_jacobian(T, P0)
    else:
        e0 = lie.se3_log(lie.se3_inverse(T) @ P0)
    r = (Si @ e0[..., None])[..., 0].reshape(S, P, 6)
    r = _where(p.pr_valid, r, torch.zeros_like(r))
    if not jacobians:
        return r, None
    J = (Si @ J).reshape(S, P, 6, 6)
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


def _linearize_and_solve(poses, points, lam, p: BAProblem, huber_delta,
                         cg_iters: int = 0):
    """One damped Gauss-Newton step: the reduced camera system, solved
    densely (``cg_iters == 0``) or by ``cg_iters`` PCG steps, then
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

    if cg_iters > 0:
        dx_p = _pcg(rhs, Hpp_d, Wab, Hll_inv, Hlp_apply, Hpl_apply, p, K,
                    cg_iters)
        dx_p = _where(p.pose_fixed, torch.zeros_like(rhs), dx_p)
        dx_l = torch.einsum("smij,smj->smi", Hll_inv, bl - Hlp_apply(dx_p))
        dx_l = _where(p.points_fixed, torch.zeros_like(dx_l), dx_l)
        return dx_p, dx_l

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


def _pcg(rhs, Hpp_d, Wab, Hll_inv, Hlp_apply, Hpl_apply, p: BAProblem,
         K: int, cg_iters: int):
    """Implicit-Schur PCG with a block-Jacobi preconditioner, batched over
    S: the Schur complement is applied as gather/segment-sum passes over
    the observations and never formed."""
    Minv = torch.linalg.inv_ex(Hpp_d)[0]

    def precond(x):
        return torch.einsum("skij,skj->ski", Minv, x)

    def S_apply(xp):
        y = torch.einsum("skij,skj->ski", Hpp_d, xp)
        # pose-edge off-diagonal blocks
        y = y + segment_sum(torch.einsum("seij,sej->sei", Wab,
                                         take(xp, p.pe_b)), p.pe_a, K)
        y = y + segment_sum(torch.einsum("seji,sej->sei", Wab,
                                         take(xp, p.pe_a)), p.pe_b, K)
        yl = torch.einsum("smij,smj->smi", Hll_inv, Hlp_apply(xp))
        y = y - Hpl_apply(yl)
        return _where(p.pose_fixed, xp, y)

    def dot(a, b):
        return torch.sum(a * b, dim=(-2, -1))[:, None, None]

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    d = z
    for _ in range(cg_iters):
        Ad = S_apply(d)
        rz = dot(r, z)
        alpha = rz / torch.clamp(dot(d, Ad), min=1e-20)
        x = x + alpha * d
        r_new = r - alpha * Ad
        z_new = precond(r_new)
        beta = dot(r_new, z_new) / torch.clamp(rz, min=1e-20)
        d = z_new + beta * d
        r, z = r_new, z_new
    return x


def lm_run(p: BAProblem, iterations: int, cg_iters: int,
           huber_delta: float, init_lambda: float) -> BAResult:
    """``iterations`` LM steps with accept/reject and lambda schedule; the
    camera system is solved densely (``cg_iters == 0``) or by ``cg_iters``
    PCG steps. Matmuls must run in full f32
    (``slam_tpu_torch/precision.py``)."""
    S = p.poses.shape[0]
    poses, points = p.poses, p.points
    cost, _ = _total_cost(poses, points, p, huber_delta)
    lam = torch.full((S,), init_lambda, dtype=poses.dtype, device=poses.device)
    for _ in range(iterations):
        dx_p, dx_l = _linearize_and_solve(poses, points, lam, p, huber_delta,
                                          cg_iters)
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
    """Solver selection shared by every BA call site, from the padded
    sizes: 0 = dense Schur direct solve, else the PCG iteration budget."""
    if n_poses_padded * n_points_padded <= DENSE_SCHUR_MAX_KM:
        return 0
    return min(6 * n_poses_padded, 96)


# The global BA's own rule (the port's; ROADMAP section 3): it solves its
# reduced camera system exactly where that fits. At the reference's budget
# (96 PCG steps above DENSE_SCHUR_MAX_KM) the KITTI-class street's global
# BA, K 624 and M 24,320 padded, stopped with its keyframes 1.5457 m from
# the truth against 1.1058 m converged. The dense solve's peak allocation
# on an H100 was 586-589 B a padded pose-point pair (the f64 coupling, its
# product with the point blocks' inverses and the einsum's copies; 1.689 GB
# at 2.87M pairs, 8.901 GB at the street's 15.2M; tools/trace_euroc_ba.py
# --replay-global), so 2^24 pairs take about 9.9 GB. Above that the global
# BA keeps the reference's PCG budget.
GLOBAL_DENSE_MAX_KM = 1 << 24


def pick_global_cg_iters(n_poses_padded: int, n_points_padded: int) -> int:
    """The global BA's solver from the padded sizes: 0 = dense Schur, else
    the reference's PCG budget (``pick_cg_iters``)."""
    if n_poses_padded * n_points_padded <= GLOBAL_DENSE_MAX_KM:
        return 0
    return pick_cg_iters(n_poses_padded, n_points_padded)


HUBER_DELTA = math.sqrt(CHI2_THRESHOLD)


def _f64(p: BAProblem) -> BAProblem:
    """The problem with its float fields in f64. A point that one keyframe
    observes gives a rank-2 3x3 block; damped by lambda it is near-singular
    (condition up to 2e9), and an f32 LM builds its Schur complement and
    steps from noise that depends on the device's rounding
    (``tools/trace_euroc_ba.py --replay-kf K`` solves one local BA of the
    EuRoC-class room both ways on the card and the CPU)."""
    return BAProblem(*(t.double() if t.is_floating_point() else t
                       for t in p))


def _as_dtype(res: BAResult, dtype: torch.dtype) -> BAResult:
    return BAResult(*(t.to(dtype) if t.is_floating_point() else t
                      for t in res))


# each entry's inputs, in order: the padding rule covers those it names
ENTRY_FIELDS = {"solve_ba": BAProblem._fields,
                "solve_ba_two_stage": BAProblem._fields + (
                    "stage2_pose_fixed", "anchor_slot", "anchor_sqrt_info")}


def _fits(b: Entry, key: tuple, fields) -> bool:
    """Whether bucket ``b`` can hold a call keyed ``key``: the same entry,
    device, stream, static arguments, dtypes and sizes, but for the padded
    pose, point and observation axes, where it is at least as large."""
    if b.key[:3] != key[:3] or b.key[4] != key[4]:
        return False
    for f, (shape, dt), (held, held_dt) in zip(fields, key[3], b.key[3]):
        if dt != held_dt or len(shape) != len(held):
            return False
        grows = PADDING.get(f, (None,))[0] in ("K", "M", "O")
        for d, (n, h) in enumerate(zip(shape, held)):
            if h < n if (d == 1 and grows) else h != n:
                return False
    return True


def pad_into(entry: str, held, tensors) -> None:
    """Copy a call's ``tensors`` into the leading slices of a covering
    bucket's buffers ``held`` and pad the rest (:func:`fill_padding`)."""
    for f, d, s in zip(ENTRY_FIELDS[entry], held, tensors):
        if d.shape == s.shape:
            d.copy_(s, non_blocking=True)
        else:
            n = s.shape[1]
            d[:, :n].copy_(s, non_blocking=True)
            fill_padding(d, f, n)


# one program per entry and padded bucket, process-wide, as the JAX
# package's jit cache holds one compiled program per static arguments and
# padded shapes (slam_tpu/ops/ba.py:333, :507); its facts are in ops/graphs'
# table
BA_GRAPHS = GraphCache("ba", pool="stream", lock="device",
                       capture_error_mode="thread_local", warm_up=True)
_SERVED = threading.local()      # this thread's last call's bucket


def _cover(key: tuple, on_card: bool):
    """The policy that picks, among the held buckets, the smallest that
    can take a first call keyed ``key``."""
    def pick(held):
        fit = [b for b in held
               if (b.graph if on_card else b.inputs) is not None
               and _fits(b, key, ENTRY_FIELDS[key[0]])]
        return min(fit, key=lambda b: sum(math.prod(shape)
                                          for shape, _ in b.key[3]),
                   default=None)
    return pick


def _dispatch(entry: str, fn, tensors, device, **static) -> BAResult:
    """``fn(*tensors)`` (a ``BAResult``) as ``entry``'s program for these
    shapes and ``static`` on ``device`` (:data:`BA_GRAPHS`). ``tensors``
    may lie on the host (pinned, for an asynchronous copy) or on
    ``device``.

    A bucket is the entry, the device, the caller's current stream, every
    input's shape and dtype, and the static arguments. Its later calls run
    through its fixed buffers (``ops/graphs``); the result is a copy of its
    outputs, taken under the per-device lock.

    A bucket's first call is covered where it can be (:func:`_cover`): the held
    bucket of its entry, device, stream, dtypes and static arguments with the
    fewest padded elements, the same S, E and P, at least its K, M and O, and a
    graph (on the CPU, buffers) takes it. Its tensors go into the leading
    slices of that bucket's buffers, the rest is padded as
    ``_ProblemBuilder.build`` pads a problem (:func:`pad_into`,
    :func:`fill_padding`), the bucket is replayed (on the CPU, its twin run),
    and the result is cut back to the call's K, M and O. The padded slots add
    exact zeros to the float64 LM, so the solve is the call's own problem,
    rounded as the larger bucket's sums and solves round it: bit-equal to its
    own bucket's solve on the CPU, within float32 last bits on a card
    (``tests/test_torch_ba_cover.py``, ``tests/test_torch_ba_card.py``). A
    first call that nothing covers runs the op-by-op twin on its own tensors.
    Either way the call makes its bucket, which its next call captures: a cover
    stands in for a shape's first call only, so which buckets a process ends
    with does not depend on the order it met them, and once a session's shapes
    all have their buckets, its solves do not depend on what else the process
    holds. :func:`last_served` names the bucket that solved the thread's last
    call. While ``utils/timer`` is on, the copy and padding of a covered call
    is the span ``ba.cover_pad``; whoever collects the result takes the
    replay's CUDA events (``BA_GRAPHS.take_replay_events``)."""
    device, on_card, stream = where(device)
    key = (entry, device, stream,
           tuple((tuple(t.shape), t.dtype) for t in tensors),
           tuple(sorted(static.items())))
    # the first 18 tensors are a BAProblem's fields
    b, first = BA_GRAPHS.entry(key, dict(
        entry=entry, S=tensors[0].shape[0], K=tensors[0].shape[1],
        M=tensors[2].shape[1], O=tensors[4].shape[1],
        E=tensors[9].shape[1], P=tensors[14].shape[1], **static))
    into = BA_GRAPHS.cover(_cover(key, on_card)) if first else b
    covered = first and into is not None
    _SERVED.dims = dict((into or b).dims, covered=covered)
    if into is None:
        return BA_GRAPHS.eager(fn, *(t.to(device, non_blocking=True)
                                     for t in tensors))
    with BA_GRAPHS.hold(into, device):
        if covered:
            with timer.section("ba.cover_pad"):
                pad_into(entry, into.inputs, tensors)
        else:
            BA_GRAPHS.copy_in(b, tensors, device)
        out = BA_GRAPHS.run(into, lambda: fn(*into.inputs), device,
                            own=not covered)
        if covered:
            k, m, o = (tensors[i].shape[1] for i in (0, 2, 4))
            out = BAResult(out.poses[:, :k], out.points[:, :m],
                           out.obs_chi2[:, :o], out.cost)
        return BAResult(*(t.clone() for t in out))


def last_served() -> Optional[dict]:
    """The sizes and static arguments of the bucket that solved this
    thread's last call, ``covered`` True where that was a larger bucket
    covering it (the sizes of the solve, padding included)."""
    return getattr(_SERVED, "dims", None)


def solve_ba_eager(p: BAProblem, iterations: int, cg_iters: int,
                   huber_delta: float = HUBER_DELTA,
                   init_lambda: float = 1e-4) -> BAResult:
    """One LM solve op by op, run in f64 (``_f64``) and returned in the
    problem's dtype: the twin of ``solve_ba``'s program."""
    pin_full_f32()
    return _as_dtype(lm_run(_f64(p), iterations, cg_iters, huber_delta,
                            init_lambda), p.poses.dtype)


def solve_ba(p: BAProblem, iterations: int, cg_iters: int,
             huber_delta: float = HUBER_DELTA,
             init_lambda: float = 1e-4, *,
             device: Optional[torch.device] = None) -> BAResult:
    """``solve_ba_eager`` as one program per padded bucket
    (:data:`BA_GRAPHS`), on ``device`` (default: where ``p`` lies; a
    problem in pinned host memory is copied straight into the bucket's
    buffers)."""
    pin_full_f32()
    return _dispatch(
        "solve_ba", lambda *t: solve_ba_eager(
            BAProblem(*t), iterations, cg_iters, huber_delta, init_lambda),
        tuple(p), p.poses.device if device is None else device,
        iterations=iterations, cg_iters=cg_iters, huber_delta=huber_delta,
        init_lambda=init_lambda)


def two_stage_lm(p: BAProblem, stage2_pose_fixed: torch.Tensor,
                 anchor_slot: torch.Tensor, anchor_sqrt_info: torch.Tensor,
                 iterations: int, cg_iters: int,
                 huber_delta: float = HUBER_DELTA,
                 init_lambda: float = 1e-4) -> BAResult:
    """Local BA's two-stage schedule (reference:
    bundle_adjuster.cpp:321-373), batched over S, in the problem's dtype
    (as ``lm_run``).

    Stage 1 runs with ``p.pose_fixed`` (all but the current keyframe
    fixed); stage 2 unfixes per ``stage2_pose_fixed`` (S, K) and softly
    anchors the stage-1 pose of keyframe ``anchor_slot`` (S,) with the
    unary prior ``anchor_sqrt_info`` (S, 6, 6)."""
    res1 = lm_run(p, iterations, cg_iters, huber_delta, init_lambda)
    slot = anchor_slot.to(torch.int64)[:, None]
    S = slot.shape[0]
    p2 = p._replace(
        poses=res1.poses,
        points=res1.points,
        pose_fixed=stage2_pose_fixed,
        pr_idx=slot,
        pr_meas=take(res1.poses, slot),
        pr_sqrt_info=anchor_sqrt_info.to(p.poses.dtype)[:, None],
        pr_valid=torch.ones((S, 1), dtype=torch.bool,
                            device=slot.device))
    return lm_run(p2, iterations, cg_iters, huber_delta, init_lambda)


def solve_ba_two_stage_eager(p: BAProblem, stage2_pose_fixed: torch.Tensor,
                             anchor_slot: torch.Tensor,
                             anchor_sqrt_info: torch.Tensor,
                             iterations: int, cg_iters: int,
                             huber_delta: float = HUBER_DELTA,
                             init_lambda: float = 1e-4) -> BAResult:
    """``two_stage_lm`` op by op, run in f64 (``_f64``) and returned in
    the problem's dtype: the twin of ``solve_ba_two_stage``'s program."""
    pin_full_f32()
    return _as_dtype(two_stage_lm(_f64(p), stage2_pose_fixed, anchor_slot,
                                  anchor_sqrt_info, iterations, cg_iters,
                                  huber_delta, init_lambda), p.poses.dtype)


def solve_ba_two_stage(p: BAProblem, stage2_pose_fixed: torch.Tensor,
                       anchor_slot: torch.Tensor,
                       anchor_sqrt_info: torch.Tensor,
                       iterations: int, cg_iters: int,
                       huber_delta: float = HUBER_DELTA,
                       init_lambda: float = 1e-4, *,
                       device: Optional[torch.device] = None) -> BAResult:
    """``solve_ba_two_stage_eager`` as one program per padded bucket
    (:data:`BA_GRAPHS`), on ``device`` as ``solve_ba``."""
    pin_full_f32()
    n = len(p)
    return _dispatch(
        "solve_ba_two_stage", lambda *t: solve_ba_two_stage_eager(
            BAProblem(*t[:n]), *t[n:], iterations, cg_iters, huber_delta,
            init_lambda),
        (*p, stage2_pose_fixed, anchor_slot, anchor_sqrt_info),
        p.poses.device if device is None else device,
        iterations=iterations, cg_iters=cg_iters, huber_delta=huber_delta,
        init_lambda=init_lambda)
