"""The plain reference that decides ``correct``.

Plain torch and NumPy. It imports nothing of the program (``slam_tpu_torch``)
and nothing of JAX; it reads the program's outputs only to judge them, and
works out again whatever the program derived:

- ``hamming_argmin``: the nearest codeword of each 256-bit descriptor (min
  Hamming distance, first index on ties), by XOR and a byte popcount table;
- ``mutual_nn_lowe_count``: the closure stack's descriptor matching
  (mutual nearest neighbour, Lowe ratio, an absolute distance limit);
- ``two_stage_lm`` / ``lm_run``: the local BA's Levenberg-Marquardt solve,
  written out from its definition (Huber-weighted normalized reprojection
  edges, SE3 odometry edges ``log(Tb^-1 C Ta)`` and unary priors
  ``log(T^-1 P)``, left-multiplicative updates, a Schur solve with the
  points eliminated, accept on a lower cost, lambda halved or quadrupled);
  the stage-2 schedule anchors the stage-1 pose of one keyframe;
- ``pose_lm``: the device VO's pose-only LM, set up again from what the
  program handed it (the landmarks, their matched measurements and
  observation counts, the predicted pose) and solved by ``lm_run``;
- ``best_score``: the retrieval's best cosine score over ring signatures,
  in float64 (or from TF32-rounded inputs, for the control);
- ``ate``: translation-aligned RMSE of camera centres.

Tangents are [omega, upsilon]; the pose-edge and prior Jacobians are taken
by forward-mode autodiff of these definitions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_POPCOUNT = None


def _popcount_table(device):
    global _POPCOUNT
    if _POPCOUNT is None or _POPCOUNT.device != torch.device(device):
        _POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                                 dtype=torch.int16, device=device)
    return _POPCOUNT


def _bytes(desc_u32: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(desc_u32, np.uint32).view(np.uint8)
    return torch.from_numpy(a.reshape(len(desc_u32), 32)).to(device)


def hamming_argmin(desc_u32: np.ndarray, codebook_u32: np.ndarray, device,
                   block: int = 4096):
    """(N, 8) x (V, 8) uint32 -> (dist (N,), idx (N,)) int64; ties go to
    the first index."""
    table = _popcount_table(device)
    d = _bytes(desc_u32, device)
    c = _bytes(codebook_u32, device)
    best_d = torch.full((len(d),), 1 << 20, dtype=torch.int64, device=device)
    best_i = torch.zeros(len(d), dtype=torch.int64, device=device)
    for s in range(0, len(c), block):
        x = torch.bitwise_xor(d[:, None, :], c[None, s:s + block, :])
        dist = table[x.to(torch.int64)].sum(dim=-1, dtype=torch.int64)
        dmin, imin = torch.min(dist, dim=1)      # first index on ties
        better = dmin < best_d
        best_d = torch.where(better, dmin, best_d)
        best_i = torch.where(better, imin + s, best_i)
    return best_d.cpu().numpy(), best_i.cpu().numpy()


def hamming_matrix(a_u32: np.ndarray, b_u32: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) int64 Hamming distances."""
    x = np.bitwise_xor(a_u32[:, None, :].astype(np.uint32),
                       b_u32[None, :, :].astype(np.uint32))
    by = x.view(np.uint8)
    return np.unpackbits(by, axis=-1).sum(axis=-1, dtype=np.int64)


def mutual_nn_lowe_count(desc_q, desc_c, valid_q, valid_c, lowe_ratio,
                         max_dist) -> int:
    """Matches between two descriptor sets: each query's nearest candidate
    is within ``max_dist``, within ``lowe_ratio`` of its second nearest,
    and has that query as its own nearest."""
    d = hamming_matrix(desc_q, desc_c)
    big = 10_000
    d[~valid_q, :] = big
    d[:, ~valid_c] = big
    if d.shape[1] < 2:
        return 0
    best = np.argmin(d, axis=1)
    srt = np.sort(d, axis=1)
    back = np.argmin(d, axis=0)
    rows = np.arange(d.shape[0])
    ok = (valid_q & (srt[:, 0] <= max_dist)
          & (srt[:, 0] <= lowe_ratio * srt[:, 1]) & (back[best] == rows))
    return int(ok.sum())


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10 explicit mantissa bits (round to
    nearest, ties to even), as a tensor core reads them."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def best_score(ring: np.ndarray, query: np.ndarray, tf32: bool = False
               ) -> float:
    """The retrieval's best cosine score of ``query`` over the signatures
    ``ring`` (rows), -1 when there is none; in float64, or with ``tf32``
    from TF32-rounded inputs with float32 products and sums."""
    if len(ring) == 0:
        return -1.0
    if tf32:
        r = round_tf32(ring.astype(np.float32))
        q = round_tf32(query.astype(np.float32))
        return float((r @ q).max())
    return float((ring.astype(np.float64) @ query.astype(np.float64)).max())


def ate(centers: np.ndarray, truth: np.ndarray) -> float:
    """RMSE of camera centres after removing the mean offset."""
    err = np.asarray(centers, np.float64) - np.asarray(truth, np.float64)
    err = err - err.mean(axis=0)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def camera_centers(poses_cw: np.ndarray) -> np.ndarray:
    p = np.asarray(poses_cw, np.float64)
    R, t = p[..., :3, :3], p[..., :3, 3]
    return -np.einsum("...ji,...j->...i", R, t)


# ---------------------------------------------------------------- SE3


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _ab(theta2):
    """sin(t)/t, (1-cos t)/t^2, (t-sin t)/t^3 of (..., 1) squared angles,
    with series near 0. Every coefficient keeps a trailing axis: forward
    derivatives of 0-d tensors scaled by Python floats come out in
    float64, which would break an f32 control."""
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    th = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (th - torch.sin(th)) / (th * th * th))
    return a, b, c


def se3_exp(xi):
    w, u = xi[..., :3], xi[..., 3:]
    a, b, c = _ab(torch.sum(w * w, dim=-1, keepdim=True))
    K = skew(w)
    KK = K @ K
    R = _eye(3, xi) + a[..., None] * K + b[..., None] * KK
    V = _eye(3, xi) + b[..., None] * K + c[..., None] * KK
    t = (V @ u[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=xi.dtype,
                         device=xi.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def so3_log(R):
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True)
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    # near the identity a series in |w|^2, with arccos kept off 1 there so
    # that forward derivatives stay finite
    small = cos_t > 1.0 - 1e-7
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_t), cos_t))
    s = torch.where(small, torch.ones_like(theta), 2.0 * torch.sin(theta))
    scale = torch.where(small, 0.5 + torch.sum(w * w, -1, keepdim=True) / 48.0,
                        theta / s)
    return w * scale


def se3_log(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    th = torch.where(small, torch.ones_like(theta), theta)
    half = th / 2.0
    k = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * torch.cos(half) / torch.sin(half)) / (th * th))
    K = skew(w)
    Vinv = _eye(3, T) - 0.5 * K + k[..., None] * (K @ K)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], dim=-1)


def se3_inv(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = -(Rt @ T[..., :3, 3:])[..., 0]
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def _edge_error(da, db, Ta, Tb, C):
    return se3_log(se3_inv(se3_exp(db) @ Tb) @ C @ (se3_exp(da) @ Ta))


def _prior_error(d, T, P):
    return se3_log(se3_inv(se3_exp(d) @ T) @ P)


def _edge_jacobians(Ta, Tb, C):
    """Errors (E, 6) and Jacobians (E, 6, 6) with respect to left
    perturbations of both vertices."""
    z = torch.zeros(Ta.shape[:-2] + (6,), dtype=Ta.dtype, device=Ta.device)
    if Ta.shape[0] == 0:
        e = torch.zeros_like(z)
        return e, z[..., None].expand(-1, 6, 6), z[..., None].expand(-1, 6, 6)
    f = torch.func.vmap(torch.func.jacfwd(_edge_error, argnums=(0, 1)))
    Ja, Jb = f(z, z, Ta, Tb, C)
    e = _edge_error(z, z, Ta, Tb, C)
    return e, Ja, Jb


def _prior_jacobian(T, P):
    z = torch.zeros(T.shape[:-2] + (6,), dtype=T.dtype, device=T.device)
    if T.shape[0] == 0:
        return torch.zeros_like(z), z[..., None].expand(-1, 6, 6)
    J = torch.func.vmap(torch.func.jacfwd(_prior_error))(z, T, P)
    return _prior_error(z, T, P), J


# ---------------------------------------------------------------- LM

_PROBLEM_FIELDS = ("poses", "pose_fixed", "points", "points_fixed", "obs_kf",
                   "obs_mp", "obs_meas", "obs_sqrt_info", "obs_valid", "pe_a",
                   "pe_b", "pe_meas", "pe_sqrt_info", "pe_valid", "pr_idx",
                   "pr_meas", "pr_sqrt_info", "pr_valid")


def _reproj(poses, points, p, huber):
    T = poses[p["obs_kf"]]
    X = points[p["obs_mp"]]
    pc = (T[:, :3, :3] @ X[:, :, None])[..., 0] + T[:, :3, 3]
    z = pc[:, 2]
    z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    r = (pc[:, :2] / z[:, None] - p["obs_meas"]) * p["obs_sqrt_info"][:, None]
    chi2 = torch.where(p["obs_valid"], (r * r).sum(-1), torch.zeros_like(z))
    return pc, z, r, chi2


def _cost(poses, points, p, huber):
    _, _, _, chi2 = _reproj(poses, points, p, huber)
    d2 = huber * huber
    rho = torch.where(chi2 <= d2, chi2,
                      2.0 * huber * torch.sqrt(torch.clamp(chi2, min=1e-12))
                      - d2)
    cost = (rho * p["obs_valid"]).sum()
    if p["pe_a"].shape[0]:
        z = poses.new_zeros(p["pe_a"].shape[0], 6)
        e = _edge_error(z, z, poses[p["pe_a"]], poses[p["pe_b"]],
                        p["pe_meas"])
        r = (p["pe_sqrt_info"] @ e[..., None])[..., 0]
        cost = cost + (r * r * p["pe_valid"][:, None]).sum()
    if p["pr_idx"].shape[0]:
        T = poses[p["pr_idx"]]
        e = _prior_error(T.new_zeros(T.shape[0], 6), T, p["pr_meas"])
        r = (p["pr_sqrt_info"] @ e[..., None])[..., 0]
        cost = cost + (r * r * p["pr_valid"][:, None]).sum()
    return cost, chi2


def _step(poses, points, lam, p, huber, cg_iters):
    K, M = poses.shape[0], points.shape[0]
    dt, dev = poses.dtype, poses.device
    pc, z, r, chi2 = _reproj(poses, points, p, huber)
    w = torch.clamp(huber / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)
    w = torch.where(p["obs_valid"], w, torch.zeros_like(w))
    sw = torch.sqrt(w)
    zero = torch.zeros_like(z)
    Jproj = torch.stack([torch.stack([1 / z, zero, -pc[:, 0] / z ** 2], -1),
                         torch.stack([zero, 1 / z, -pc[:, 1] / z ** 2], -1)],
                        -2)
    scale = (p["obs_sqrt_info"] * sw)[:, None, None]
    Jc = torch.cat([-skew(pc), _eye(3, pc).expand(len(pc), 3, 3)], -1)
    Jp = Jproj @ Jc * scale
    Jl = Jproj @ poses[p["obs_kf"]][:, :3, :3] * scale
    Jp = torch.where(p["pose_fixed"][p["obs_kf"]][:, None, None],
                     torch.zeros_like(Jp), Jp)
    Jl = torch.where(p["points_fixed"][p["obs_mp"]][:, None, None],
                     torch.zeros_like(Jl), Jl)
    rw = r * sw[:, None]

    Hpp = torch.zeros(K, 6, 6, dtype=dt, device=dev)
    bp = torch.zeros(K, 6, dtype=dt, device=dev)
    Hll = torch.zeros(M, 3, 3, dtype=dt, device=dev)
    bl = torch.zeros(M, 3, dtype=dt, device=dev)
    Hpp.index_add_(0, p["obs_kf"], Jp.transpose(1, 2) @ Jp)
    bp.index_add_(0, p["obs_kf"], -(Jp.transpose(1, 2) @ rw[..., None])[..., 0])
    Hll.index_add_(0, p["obs_mp"], Jl.transpose(1, 2) @ Jl)
    bl.index_add_(0, p["obs_mp"], -(Jl.transpose(1, 2) @ rw[..., None])[..., 0])

    offdiag = []                     # (a, b, Ja^T Jb) of each odometry edge
    if p["pe_a"].shape[0]:
        a, b = p["pe_a"], p["pe_b"]
        e, Ja, Jb = _edge_jacobians(poses[a], poses[b], p["pe_meas"])
        Si = p["pe_sqrt_info"]
        ok = p["pe_valid"]
        re = torch.where(ok[:, None], (Si @ e[..., None])[..., 0],
                         torch.zeros_like(e))
        Ja = torch.where((ok & ~p["pose_fixed"][a])[:, None, None], Si @ Ja,
                         torch.zeros_like(Ja))
        Jb = torch.where((ok & ~p["pose_fixed"][b])[:, None, None], Si @ Jb,
                         torch.zeros_like(Jb))
        Hpp.index_add_(0, a, Ja.transpose(1, 2) @ Ja)
        Hpp.index_add_(0, b, Jb.transpose(1, 2) @ Jb)
        bp.index_add_(0, a, -(Ja.transpose(1, 2) @ re[..., None])[..., 0])
        bp.index_add_(0, b, -(Jb.transpose(1, 2) @ re[..., None])[..., 0])
        offdiag = (a, b, Ja.transpose(1, 2) @ Jb)
    if p["pr_idx"].shape[0]:
        i = p["pr_idx"]
        e, J = _prior_jacobian(poses[i], p["pr_meas"])
        Si = p["pr_sqrt_info"]
        ok = p["pr_valid"]
        re = torch.where(ok[:, None], (Si @ e[..., None])[..., 0],
                         torch.zeros_like(e))
        J = torch.where((ok & ~p["pose_fixed"][i])[:, None, None], Si @ J,
                        torch.zeros_like(J))
        Hpp.index_add_(0, i, J.transpose(1, 2) @ J)
        bp.index_add_(0, i, -(J.transpose(1, 2) @ re[..., None])[..., 0])

    damp = lam + 1e-8
    fixed_p, fixed_l = p["pose_fixed"], p["points_fixed"]
    Hpp_d = torch.where(fixed_p[:, None, None], _eye(6, Hpp).expand_as(Hpp),
                        Hpp + damp * _eye(6, Hpp))
    Hll_d = torch.where(fixed_l[:, None, None], _eye(3, Hll).expand_as(Hll),
                        Hll + damp * _eye(3, Hll))
    Hll_inv = torch.linalg.inv(Hll_d)
    bl = torch.where(fixed_l[:, None], torch.zeros_like(bl), bl)
    bp = torch.where(fixed_p[:, None], torch.zeros_like(bp), bp)

    def lp(xp):          # H_lp xp: (M, 3)
        v = (Jp @ xp[p["obs_kf"]][..., None])[..., 0]
        out = torch.zeros(M, 3, dtype=dt, device=dev)
        return out.index_add_(0, p["obs_mp"],
                              (Jl.transpose(1, 2) @ v[..., None])[..., 0])

    def pl(xl):          # H_pl xl: (K, 6)
        v = (Jl @ xl[p["obs_mp"]][..., None])[..., 0]
        out = torch.zeros(K, 6, dtype=dt, device=dev)
        return out.index_add_(0, p["obs_kf"],
                              (Jp.transpose(1, 2) @ v[..., None])[..., 0])

    rhs = bp - pl((Hll_inv @ bl[..., None])[..., 0])
    rhs = torch.where(fixed_p[:, None], torch.zeros_like(rhs), rhs)
    if cg_iters > 0:
        dxp = _pcg(rhs, Hpp_d, offdiag, Hll_inv, lp, pl, fixed_p, cg_iters)
    else:
        W = torch.zeros(K * M, 6, 3, dtype=dt, device=dev)
        W.index_add_(0, p["obs_kf"] * M + p["obs_mp"],
                     Jp.transpose(1, 2) @ Jl)
        W = W.reshape(K, M, 6, 3)
        Y = torch.einsum("kmij,mjl->kmil", W, Hll_inv)
        S = -torch.einsum("kmil,qmjl->kiqj", Y, W)            # (K,6,K,6)
        if len(offdiag):
            a, b, Wab = offdiag
            for n in range(len(a)):
                S[a[n], :, b[n], :] += Wab[n]
                S[b[n], :, a[n], :] += Wab[n].T
        for k in range(K):
            S[k, :, k, :] += Hpp_d[k]
        fk = fixed_p
        S[fk] = 0.0
        S[:, :, fk] = 0.0
        idx = torch.nonzero(fk)[:, 0]
        for k in idx.tolist():
            S[k, :, k, :] = _eye(6, S)
        dxp = torch.linalg.solve(S.reshape(6 * K, 6 * K),
                                 rhs.reshape(6 * K))
        dxp = dxp.reshape(K, 6)
    dxp = torch.where(fixed_p[:, None], torch.zeros_like(dxp), dxp)
    dxl = (Hll_inv @ (bl - lp(dxp))[..., None])[..., 0]
    dxl = torch.where(fixed_l[:, None], torch.zeros_like(dxl), dxl)
    return dxp, dxl


def _pcg(rhs, Hpp_d, offdiag, Hll_inv, lp, pl, fixed_p, iters):
    Minv = torch.linalg.inv(Hpp_d)

    def apply(x):
        y = (Hpp_d @ x[..., None])[..., 0]
        if len(offdiag):
            a, b, Wab = offdiag
            y = y.index_add(0, a, (Wab @ x[b][..., None])[..., 0])
            y = y.index_add(0, b, (Wab.transpose(1, 2) @ x[a][..., None])[..., 0])
        y = y - pl((Hll_inv @ lp(x)[..., None])[..., 0])
        return torch.where(fixed_p[:, None], x, y)

    x = torch.zeros_like(rhs)
    r = rhs
    z = (Minv @ r[..., None])[..., 0]
    d = z
    for _ in range(iters):
        Ad = apply(d)
        rz = (r * z).sum()
        alpha = rz / torch.clamp((d * Ad).sum(), min=1e-20)
        x = x + alpha * d
        r_new = r - alpha * Ad
        z_new = (Minv @ r_new[..., None])[..., 0]
        beta = (r_new * z_new).sum() / torch.clamp(rz, min=1e-20)
        d = z_new + beta * d
        r, z = r_new, z_new
    return x


def lm_run(p: dict, iterations: int, cg_iters: int, huber: float,
           init_lambda: float):
    """``iterations`` damped Gauss-Newton steps on one problem (a dict of
    the fields above, no batch dimension). Returns (poses, points, cost)."""
    poses, points = p["poses"], p["points"]
    cost, _ = _cost(poses, points, p, huber)
    lam = torch.tensor(init_lambda, dtype=poses.dtype, device=poses.device)
    for _ in range(iterations):
        dxp, dxl = _step(poses, points, lam, p, huber, cg_iters)
        new_poses = se3_exp(dxp) @ poses
        new_points = points + dxl
        new_cost, _ = _cost(new_poses, new_points, p, huber)
        accept = bool(new_cost < cost)
        if accept:
            poses, points, cost = new_poses, new_points, new_cost
        lam = torch.clamp(lam * (0.5 if accept else 4.0), 1e-9, 1e6)
    return poses, points, cost


def problem(tensors, s: int, dtype, device) -> dict:
    """Sequence ``s`` of a recorded batched problem (18 BAProblem fields)
    as a dict, floats in ``dtype``."""
    out = {}
    for name, t in zip(_PROBLEM_FIELDS, tensors):
        t = t[s].to(device)
        out[name] = t.to(dtype) if t.is_floating_point() else t
    return out


def two_stage_lm(p: dict, stage2_pose_fixed, anchor_slot: int,
                 anchor_sqrt_info, iterations: int, cg_iters: int,
                 huber: float, init_lambda: float):
    """The local BA's schedule: stage 1 with ``p``'s fixed poses, stage 2
    with ``stage2_pose_fixed`` and the stage-1 pose of ``anchor_slot``
    held by a unary prior of ``anchor_sqrt_info`` in place of ``p``'s
    priors."""
    poses, points, _ = lm_run(p, iterations, cg_iters, huber, init_lambda)
    dt = poses.dtype
    p2 = dict(p, poses=poses, points=points, pose_fixed=stage2_pose_fixed,
              pr_idx=torch.tensor([anchor_slot], device=poses.device),
              pr_meas=poses[anchor_slot][None],
              pr_sqrt_info=anchor_sqrt_info.to(dt)[None],
              pr_valid=torch.ones(1, dtype=torch.bool, device=poses.device))
    return lm_run(p2, iterations, cg_iters, huber, init_lambda)


# ---------------------------------------------------------------- device VO


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """The device VO's solver settings as a configuration states them
    (``device_vo`` and ``camera`` of ``configs/<name>.json``)."""
    focal: float
    pose_iterations: int
    rot_weight: float
    pos_weight: float
    obs_weight_scale: float
    maturity_ramp: float
    maturity_floor: float
    huber: float = float(np.sqrt(5.991))
    init_lambda: float = 1e-4

    @classmethod
    def of(cls, cfg: dict) -> "SolverSettings":
        v = cfg["device_vo"]
        return cls(focal=float(cfg["camera"]["fx"]),
                   pose_iterations=int(v["ba_iterations"]),
                   rot_weight=float(v["odom_rot_weight"]),
                   pos_weight=float(v["odom_pos_weight"]),
                   obs_weight_scale=float(v["obs_weight_scale"]),
                   maturity_ramp=float(v["maturity_ramp"]),
                   maturity_floor=float(v["maturity_floor"]))

    def odom_info(self, dtype, device):
        """diag(rotation x3, position x3): the odometry prior's
        whitening."""
        return torch.diag(torch.tensor([self.rot_weight] * 3
                                       + [self.pos_weight] * 3,
                                       dtype=dtype, device=device))

    def maturity(self, n_obs):
        return torch.clamp((n_obs - 1.0) / self.maturity_ramp,
                           self.maturity_floor, 1.0)


def loop_codebook(vocabulary_path: str, num_words: int) -> np.ndarray:
    """The retrieval's (W, 8) uint32 codebook: a uniform stride over the
    trained vocabulary file's codewords."""
    base = np.load(vocabulary_path)["codebook"]
    stride = max(1, len(base) // num_words)
    return np.ascontiguousarray(base[::stride][:num_words])


def pose_lm(lm_pos, lm_n_obs, pose_pred, meas, matched, sc: SolverSettings,
            dtype, device):
    """One sequence's tracking solve: the predicted pose free, every
    landmark fixed and observed once at its matched measurement (only the
    matched ones count), weighted by focal x scale x the landmark's
    maturity, and a unary prior holding the prediction. Returns the
    solved (4, 4) pose."""
    M = lm_pos.shape[0]
    f = lambda t: t.to(device=device, dtype=dtype)      # noqa: E731
    pred = f(pose_pred)
    weight = sc.focal * sc.obs_weight_scale * sc.maturity(f(lm_n_obs))
    none = torch.zeros(0, dtype=torch.int64, device=device)
    p = dict(poses=pred[None],
             pose_fixed=torch.zeros(1, dtype=torch.bool, device=device),
             points=f(lm_pos),
             points_fixed=torch.ones(M, dtype=torch.bool, device=device),
             obs_kf=torch.zeros(M, dtype=torch.int64, device=device),
             obs_mp=torch.arange(M, device=device), obs_meas=f(meas),
             obs_sqrt_info=weight, obs_valid=matched.to(device),
             pr_idx=torch.zeros(1, dtype=torch.int64, device=device),
             pr_meas=pred[None],
             pr_sqrt_info=sc.odom_info(dtype, device)[None],
             pr_valid=torch.ones(1, dtype=torch.bool, device=device),
             pe_a=none, pe_b=none,
             pe_meas=torch.zeros(0, 4, 4, dtype=dtype, device=device),
             pe_sqrt_info=torch.zeros(0, 6, 6, dtype=dtype, device=device),
             pe_valid=torch.zeros(0, dtype=torch.bool, device=device))
    poses, _, _ = lm_run(p, sc.pose_iterations, 0, sc.huber, sc.init_lambda)
    return poses[0]
