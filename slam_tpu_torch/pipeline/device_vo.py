"""Device-resident batched VO backend (port of
slam_tpu/pipeline/device_vo.py).

S independent sequences advance together: every tensor of the state carries
a leading batch dimension S where the JAX package ``vmap``s, and the frames
of a chunk run in a Python loop where it ``scan``s. Where it ``jit``s the
chunk into one program, a card captures the chunk once as a CUDA graph and
replays it (``_ChunkGraph``). The landmark store
(static capacity + masks) stays on the device between chunks. Per frame:
fused ORB front-end, projection-gated Hamming mutual-NN map matching,
pose-only LM, anchored-depth refinement, two-view landmark creation,
staleness culling, sliding-window bookkeeping and, when
``cfg.loop_every > 0``, loop-candidate retrieval whose descriptor
quantisation runs the hand-written ``hamming_argmin`` CUDA kernel on the
card. Every ``window_ba_every`` frames a dense-Schur window BA
(``ops/ba.lm_run``) refines the last ``window`` poses and their landmarks.

No step reads a value back to the host. Scatters that the JAX package
drops with ``mode="drop"`` write to a scratch row M of a temporary buffer.
"""
from __future__ import annotations

import threading
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from slam_tpu_torch.geometry.camera import PinholeCamera
from slam_tpu_torch.ops import ba, lie
from slam_tpu_torch.ops.bow import make_codebook
from slam_tpu_torch.ops.camera import pack_camera, project, unproject
from slam_tpu_torch.ops.frontend import FrontendSpec, extract, min_distances
from slam_tpu_torch.ops.graphs import GraphCache
from slam_tpu_torch.ops.hamming import (HAMMING_DIST_THR_LOW, MASK_DIST,
                                        hamming_matrix, mutual_nn)
from slam_tpu_torch.ops.hamming_argmin import hamming_argmin
from slam_tpu_torch.ops.pyramid import level_sizes
from slam_tpu_torch.ops.ransac import triangulate_two_view
from slam_tpu_torch.ops.stamp import Stamper
from slam_tpu_torch.params import Parameters, ParametersSlam, StaticSettings
from slam_tpu_torch.precision import pin_full_f32
from slam_tpu_torch.utils import timer

take = ba.take


class VOState(NamedTuple):
    """Per-sequence map/tracking state, batched over S sequences (see the
    JAX package's VOState for the meaning of each field). Descriptor fields
    hold int32 bit patterns of the reference's uint32 words."""
    pose_cw: torch.Tensor         # (S, 4, 4)
    lm_pos: torch.Tensor          # (S, M, 3)
    lm_desc: torch.Tensor         # (S, M, 8) int32 bit patterns
    lm_valid: torch.Tensor        # (S, M) bool
    lm_last_seen: torch.Tensor    # (S, M) int32
    lm_anchor_origin: torch.Tensor  # (S, M, 3)
    lm_anchor_ray: torch.Tensor     # (S, M, 3)
    lm_depth: torch.Tensor          # (S, M)
    lm_n_obs: torch.Tensor          # (S, M) int32
    lm_octave: torch.Tensor         # (S, M) int32
    lm_created: torch.Tensor        # (S, M) int32
    prev_pts: torch.Tensor        # (S, N, 2)
    prev_desc: torch.Tensor       # (S, N, 8) int32 bit patterns
    prev_free: torch.Tensor       # (S, N) bool
    prev_pose_cw: torch.Tensor    # (S, 4, 4)
    frame_idx: torch.Tensor       # (S,) int32
    win_pose_cw: torch.Tensor     # (S, K, 4, 4)
    win_valid: torch.Tensor       # (S, K) bool
    win_odo: torch.Tensor         # (S, K, 4, 4)
    wobs_meas: torch.Tensor       # (S, M, K, 2)
    wobs_valid: torch.Tensor      # (S, M, K) bool
    sig_ring: torch.Tensor        # (S, R, W)
    sig_frame: torch.Tensor       # (S, R) int32
    sig_pc: torch.Tensor          # (S, R, P, 3)
    sig_desc: torch.Tensor        # (S, R, P, 8) int32 bit patterns
    sig_obs: torch.Tensor         # (S, R, P, 2)
    sig_pvalid: torch.Tensor      # (S, R, P) bool
    sig_pose: torch.Tensor        # (S, R, 4, 4)
    sig_octave: torch.Tensor      # (S, R, P) int32


class SnapOut(NamedTuple):
    """Closure-snapshot ring rows written during one chunk (C = T //
    loop_every stored slots per sequence)."""
    slot: torch.Tensor            # (S, C)
    frame: torch.Tensor           # (S, C)
    pc: torch.Tensor              # (S, C, P, 3)
    desc: torch.Tensor            # (S, C, P, 8)
    obs: torch.Tensor             # (S, C, P, 2)
    pvalid: torch.Tensor          # (S, C, P)
    pose: torch.Tensor            # (S, C, 4, 4)
    octave: torch.Tensor          # (S, C, P)


class VOStepOut(NamedTuple):
    pose_cw: torch.Tensor         # (S, 4, 4) optimized pose for the frame
    n_matched: torch.Tensor       # (S,) int32 matched landmarks
    n_new: torch.Tensor           # (S,) int32 landmarks inserted
    loop_frame: torch.Tensor      # (S,) int32 revisit candidate, -1 = none
    loop_score: torch.Tensor      # (S,) f32 its retrieval score


class DeviceVOConfig(NamedTuple):
    """Same fields and defaults as slam_tpu's DeviceVOConfig; see there for
    what each one does and how the defaults were measured."""
    width: int
    height: int
    lm_capacity: int = 512
    max_keypoints: int = 600
    match_radius_px: float = 20.0
    stale_age: int = 12
    ba_iterations: int = 4
    min_parallax_cos: float = 0.999995
    epipolar_thr_deg: float = 0.5
    max_reproj_px: float = 2.0
    obs_weight_scale: float = 1.0
    maturity_ramp: float = 8.0
    maturity_floor: float = 0.125
    odom_pos_weight: float = 1000.0
    odom_rot_weight: float = 10000.0
    max_depth_step: float = 0.1
    window: int = 8
    window_ba_every: int = 4
    window_ba_iters: int = 3
    window_free_points: bool = True
    window_maturity_weight: bool = False
    match_lowe_ratio: float = 1.0
    loop_every: int = 0
    loop_slots: int = 64
    loop_words: int = 512
    loop_min_gap: int = 30
    loop_stale_guard: int = 16
    loop_points: int = 192
    loop_min_score: float = 0.0


# fields carried as int32 bit patterns here and as uint32 in the JAX package
_DESC_FIELDS = ("lm_desc", "prev_desc", "sig_desc")
N_TRACKED = 8
# the frame step's stages, in order, each ended by a stamp: the ORB
# front-end; map matching and the pose LM; depth refinement, landmark
# creation, culling and the window's bookkeeping; loop retrieval
STEP_STAGES = ("frontend", "track", "landmarks", "retrieval")


def stamp_stages(cfg: "DeviceVOConfig", T: int) -> tuple:
    """The stage each stamp of a T-frame chunk ends, in order: the step's
    stages a frame, ``window_ba`` after every ``window_ba_every`` frames
    (with a window), and ``snaps`` (the stacked outputs and the snapshot
    rows) last. A chunk writes one more stamp, at its start."""
    out = []
    for t in range(T):
        out.extend(STEP_STAGES)
        if cfg.window > 0 and (t + 1) % cfg.window_ba_every == 0:
            out.append("window_ba")
    out.append("snaps")
    return tuple(out)


# the stamper of the chunk running on this thread (``_ChunkGraph.chunk``),
# so that the step takes no argument for it and a step wrapped by a caller
# still stamps
_STAMP = threading.local()


def _stamp() -> None:
    """End a stage of the chunk running on this thread, if it stamps."""
    stamper = getattr(_STAMP, "stamper", None)
    if stamper is not None:
        stamper()


def _frontend_spec(settings: StaticSettings, width: int, height: int
                   ) -> FrontendSpec:
    p = settings.parameters.slam
    scale_factors = tuple(float(s) for s in settings.scaleFactors)
    sizes = level_sizes(width, height, scale_factors)
    return FrontendSpec(scale_factors,
                        tuple(settings.maxNumberOfKeypointsPerLevel()),
                        tuple(min_distances(settings, sizes)),
                        int(p.orbLkTrackLevel),
                        p.slamFeatureDetector.lower() == "fast", width, height)


def _loop_codebook(num_words: int) -> np.ndarray:
    """(W, 8) uint32 retrieval codebook: a uniform stride over the trained
    65,536-word vocabulary, so every descriptor-space region is sampled."""
    base = make_codebook(65536)
    stride = max(1, len(base) // num_words)
    return np.ascontiguousarray(base[::stride][:num_words])


def _resolve_camera(cfg: DeviceVOConfig, camera):
    if camera is None:
        camera = PinholeCamera(fx=0.8 * cfg.width, fy=0.8 * cfg.width,
                               cx=cfg.width / 2.0, cy=cfg.height / 2.0,
                               width=cfg.width, height=cfg.height)
    return camera


def _resolve_settings(cfg: DeviceVOConfig,
                      settings: Optional[StaticSettings]) -> StaticSettings:
    if settings is None:
        settings = StaticSettings(Parameters(slam=ParametersSlam(
            maxKeypoints=cfg.max_keypoints)))
    return settings


def _on_device(x: torch.Tensor, values):
    """``values`` as a tensor on ``x``'s device: a Python scalar becomes a
    0-d tensor filled there, so that no indexed write copies a host scalar
    to the card (a copy that a CUDA graph capture refuses)."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.full((), values, dtype=x.dtype, device=x.device)


def _set_rows(x: torch.Tensor, slot: torch.Tensor, values, col=None):
    """``x.at[slot(, col)].set(values, mode="drop")`` per sequence: x (S, M,
    ...), slot (S, N) in [0, M]; row M is a scratch row that is dropped.
    ``col`` (S,) picks one column of a (S, M, K, ...) store."""
    S, M = x.shape[:2]
    ext = torch.cat([x, x[:, :1]], dim=1)
    b = torch.arange(S, device=x.device)[:, None]
    if col is None:
        ext[b, slot] = _on_device(x, values)
    else:
        ext[b, slot, col[:, None]] = _on_device(x, values)
    return ext[:, :M]


def _set_slot(x: torch.Tensor, slot: torch.Tensor, values):
    """``x.at[slot].set(values)`` per sequence: x (S, R, ...), slot (S,)."""
    x = x.clone()
    x[torch.arange(x.shape[0], device=x.device), slot] = _on_device(x, values)
    return x


def _transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(S, 4, 4) poses applied to (S, n, 3) points."""
    return p @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]


def _odom_sqrt_info(cfg: DeviceVOConfig, dtype, device) -> torch.Tensor:
    """(6, 6) odometry-edge information factor diag(rot x3, pos x3), built
    on the device (no host-to-device copy inside a step)."""
    return torch.diag(torch.cat([
        torch.full((3,), cfg.odom_rot_weight, dtype=dtype, device=device),
        torch.full((3,), cfg.odom_pos_weight, dtype=dtype, device=device)]))


def _match_map(state: VOState, pts, desc, feat_valid, pose_pred,
               cam_kind, cam_params, cfg: DeviceVOConfig):
    """Projection-gated mutual-nearest landmark<->feature matching."""
    pc = _transform(pose_pred, state.lm_pos)
    proj, vis = project(cam_kind, cam_params, pc)
    vis = vis & state.lm_valid & (pc[..., 2] > 1e-6)
    dist = hamming_matrix(state.lm_desc, desc)              # (S, M, N)
    d2 = torch.sum((proj[:, :, None, :] - pts[:, None, :, :]) ** 2, dim=-1)
    gate = (vis[:, :, None] & feat_valid[:, None, :]
            & (d2 <= cfg.match_radius_px ** 2))
    dist = torch.where(gate, dist, torch.full_like(dist, MASK_DIST))
    return mutual_nn(dist, HAMMING_DIST_THR_LOW, ratio=cfg.match_lowe_ratio)


def _pose_edge_r(xi, T, C, B, sqrt_info):
    """EdgeSE3Expmap error with the free (current) pose in the b slot."""
    e = lie.se3_log(lie.se3_inverse(lie.se3_exp(xi) @ T) @ C @ B)
    return (sqrt_info @ e[..., None])[..., 0]


def _pose_ba(state: VOState, pose_pred, meas_xy, matched,
             cfg: DeviceVOConfig, obs_weight):
    """Pose-only LM (poseBundleAdjust semantics): previous pose and all
    landmarks fixed, one odometry-prior edge. The 6x6 normal equation per
    sequence; same Huber weighting, damping and accept rule as ba.lm_run."""
    S = pose_pred.shape[0]
    dev = pose_pred.device
    huber_delta = float(np.float32(np.sqrt(5.991)))
    sqrt_info = _odom_sqrt_info(cfg, torch.float32, dev)
    C = pose_pred @ lie.se3_inverse(state.prev_pose_cw)
    B = state.prev_pose_cw
    X = state.lm_pos
    si = obs_weight.expand(X.shape[:2]).to(torch.float32)
    valid = matched
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def reproj_terms(T):
        pc = _transform(T, X)
        z = pc[..., 2]
        zsafe = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
        pred = pc[..., :2] / zsafe[..., None]
        r = (pred - meas_xy) * si[..., None]
        chi2 = torch.sum(r * r, dim=-1)
        rnorm = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = torch.where(valid, torch.clamp(huber_delta / rnorm, max=1.0),
                        torch.zeros_like(rnorm))
        inv_z = 1.0 / zsafe
        zero = torch.zeros_like(z)
        Jproj = torch.stack([
            torch.stack([inv_z, zero, -pc[..., 0] * inv_z * inv_z], dim=-1),
            torch.stack([zero, inv_z, -pc[..., 1] * inv_z * inv_z], dim=-1)],
            dim=-2)                                          # (S, M, 2, 3)
        Jp_pose = torch.cat([-lie.skew(pc),
                             eye6[:3, :3].expand(pc.shape[:-1] + (3, 3))],
                            dim=-1)
        J = (Jproj @ Jp_pose) * (si * torch.sqrt(w))[..., None, None]
        r_w = r * torch.sqrt(w)[..., None]
        return r_w, J, torch.where(valid, chi2, torch.zeros_like(chi2))

    zero6 = torch.zeros(S, 6, dtype=torch.float32, device=dev)

    def cost_of(T):
        _, _, chi2 = reproj_terms(T)
        cost = torch.sum(ba.robust_cost(chi2, huber_delta) * valid, dim=-1)
        re = _pose_edge_r(zero6, T, C, B, sqrt_info)
        return cost + torch.sum(re * re, dim=-1)

    T = pose_pred
    lam = torch.full((S,), 1e-4, dtype=torch.float32, device=dev)
    cost = cost_of(T)
    for _ in range(cfg.ba_iterations):
        r_w, J, _ = reproj_terms(T)
        re = _pose_edge_r(zero6, T, C, B, sqrt_info)
        Je = sqrt_info @ lie.prior_error_and_jacobian(T, C @ B)[1]
        H = (torch.einsum("smci,smcj->sij", J, J)
             + Je.transpose(-1, -2) @ Je
             + (lam + 1e-8)[:, None, None] * eye6)
        b = -(torch.einsum("smci,smc->si", J, r_w)
              + (Je.transpose(-1, -2) @ re[..., None])[..., 0])
        dx = torch.linalg.solve_ex(H, b[..., None])[0][..., 0]
        new_T = lie.se3_exp(dx) @ T
        new_cost = cost_of(new_T)
        accept = new_cost < cost
        T = torch.where(accept[:, None, None], new_T, T)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return T


def _refine_depths(state: VOState, pose_cw, meas_xy, matched,
                   cfg: DeviceVOConfig):
    """Anchored-depth refinement: two 1-D Gauss-Newton steps along the
    anchor ray, then a clamped incremental-mean blend."""
    R = pose_cw[:, :3, :3]
    a = _transform(pose_cw, state.lm_anchor_origin)
    b = state.lm_anchor_ray @ R.transpose(-1, -2)

    d = state.lm_depth
    for _ in range(2):
        pc = a + d[..., None] * b
        z = torch.clamp(pc[..., 2], min=1e-6)
        e = pc[..., :2] / z[..., None] - meas_xy
        J = (b[..., :2] * z[..., None] - pc[..., :2] * b[..., 2:3]) \
            / (z * z)[..., None]
        num = torch.sum(J * e, dim=-1)
        den = torch.clamp(torch.sum(J * J, dim=-1), min=1e-12)
        d = d - num / den
    ok = matched & (d > 1e-3) & torch.isfinite(d)
    n = torch.clamp(state.lm_n_obs, min=1).to(d.dtype)
    d_blend = state.lm_depth + (d - state.lm_depth) / (n + 1.0)
    max_move = cfg.max_depth_step * torch.clamp(state.lm_depth, min=1e-3)
    d_blend = torch.minimum(torch.maximum(d_blend, state.lm_depth - max_move),
                            state.lm_depth + max_move)
    depth = torch.where(ok, d_blend, state.lm_depth)
    n_obs = torch.where(matched, state.lm_n_obs + 1, state.lm_n_obs)
    pos = state.lm_anchor_origin + depth[..., None] * state.lm_anchor_ray
    return pos, depth, n_obs


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def _create_landmarks(state: VOState, pose_cw, pts, desc, free_cur,
                      cam_kind, cam_params, cfg: DeviceVOConfig):
    """Two-view triangulation of fresh landmarks from map-free features of
    the current and previous frames, inserted into the lowest free slots."""
    M = state.lm_pos.shape[1]
    dist = hamming_matrix(desc, state.prev_desc)
    gate = free_cur[:, :, None] & state.prev_free[:, None, :]
    dist = torch.where(gate, dist, torch.full_like(dist, MASK_DIST))
    nn_cp, mutual = mutual_nn(dist, HAMMING_DIST_THR_LOW,
                              ratio=cfg.match_lowe_ratio)

    prev_pts = take(state.prev_pts, nn_cp)
    b_cur = unproject(cam_kind, cam_params, pts)
    b_prev = unproject(cam_kind, cam_params, prev_pts)
    # camera 1 = previous frame, camera 2 = current frame
    T21 = pose_cw @ lie.se3_inverse(state.prev_pose_cw)
    R21, t21 = T21[:, :3, :3], T21[:, :3, 3]

    # epipolar gate: symmetric angular distance to the other's epipolar plane
    E = lie.skew(t21) @ R21
    n2 = b_prev @ E.transpose(-1, -2)
    n1 = b_cur @ E

    def _sin(b, n):
        num = torch.abs(torch.sum(b * n, dim=-1))
        den = torch.linalg.norm(b, dim=-1) * torch.linalg.norm(n, dim=-1)
        return num / torch.clamp(den, min=1e-12)
    sin_thr = float(np.float32(np.sin(np.radians(cfg.epipolar_thr_deg))))
    epi_ok = (_sin(b_cur, n2) < sin_thr) & (_sin(b_prev, n1) < sin_thr)

    pts_c1, tri_ok = triangulate_two_view(R21, t21, b_prev, b_cur)
    parallax_ok = torch.sum(_unit(b_prev) * _unit(b_cur @ R21), dim=-1) \
        < cfg.min_parallax_cos

    # both-frame reprojection gate on the triangulated point
    pc2 = _transform(T21, pts_c1)
    proj1, vis1 = project(cam_kind, cam_params, pts_c1)
    proj2, vis2 = project(cam_kind, cam_params, pc2)
    r2max = float(np.float32(cfg.max_reproj_px ** 2))
    reproj_ok = (vis1 & vis2
                 & (torch.sum((proj1 - prev_pts) ** 2, dim=-1) <= r2max)
                 & (torch.sum((proj2 - pts) ** 2, dim=-1) <= r2max))
    new_ok = mutual & tri_ok & parallax_ok & epi_ok & reproj_ok

    Rp = state.prev_pose_cw[:, :3, :3]
    tp = state.prev_pose_cw[:, None, :3, 3]
    pos_w = (pts_c1 - tp) @ Rp                       # R^T (p - t)
    c_prev = -tp @ Rp                                # (S, 1, 3) anchor
    ray = pos_w - c_prev
    depth = torch.linalg.norm(ray, dim=-1)
    ray = ray / torch.clamp(depth[..., None], min=1e-9)
    new_ok = new_ok & (depth > 1e-3)

    # rank new points into the lowest-index free slots; overflow -> row M
    free_slots = torch.argsort(state.lm_valid.to(torch.int32), dim=1,
                               stable=True)
    n_free = M - torch.sum(state.lm_valid, dim=1)
    rank = torch.cumsum(new_ok.to(torch.int64), dim=1) - 1
    assign = new_ok & (rank < n_free[:, None])
    slot = torch.where(assign, take(free_slots, torch.clamp(rank, 0, M - 1)),
                       torch.full_like(rank, M))
    lm_pos = _set_rows(state.lm_pos, slot, pos_w)
    lm_desc = _set_rows(state.lm_desc, slot, desc)
    lm_valid = _set_rows(state.lm_valid, slot, True)
    lm_last_seen = _set_rows(state.lm_last_seen, slot,
                             state.frame_idx[:, None].expand(slot.shape))
    lm_anchor_origin = _set_rows(state.lm_anchor_origin, slot,
                                 c_prev.expand(pos_w.shape))
    lm_anchor_ray = _set_rows(state.lm_anchor_ray, slot, ray)
    lm_depth = _set_rows(state.lm_depth, slot, depth)
    lm_n_obs = _set_rows(state.lm_n_obs, slot, 2)
    # normalized-camera measurements of the two creation observations
    meas_cur = b_cur[..., :2] / torch.clamp(b_cur[..., 2:3], min=1e-6)
    meas_prev = b_prev[..., :2] / torch.clamp(b_prev[..., 2:3], min=1e-6)
    return (lm_pos, lm_desc, lm_valid, lm_last_seen, lm_anchor_origin,
            lm_anchor_ray, lm_depth, lm_n_obs, assign, slot,
            meas_cur, meas_prev)


def _window_ba(state: VOState, cfg: DeviceVOConfig, focal: float) -> VOState:
    """Sliding-window local BA (localBundleAdjust analogue): joint LM over
    the last K poses and the landmarks observed in the window, odometry
    edges between consecutive window frames, the oldest pose fixed, then
    chi2 > 5.991 observation pruning."""
    S, K = state.win_pose_cw.shape[:2]
    M = state.lm_pos.shape[1]
    dev = state.lm_pos.device
    f32 = state.lm_pos.dtype

    last = torch.remainder(state.frame_idx - 1, K).to(torch.int64)
    n_valid = torch.sum(state.win_valid, dim=1)
    oldest = torch.remainder(state.frame_idx - n_valid, K)
    ar_k = torch.arange(K, device=dev)
    pose_fixed = ~state.win_valid | (ar_k[None] == oldest[:, None])

    # slot b holds the measured delta prev->b: edge (a = prev slot, b)
    offs = torch.arange(K - 1, device=dev)
    pe_b = torch.remainder(last[:, None] - offs, K)
    pe_a = torch.remainder(last[:, None] - offs - 1, K)
    pe_valid = take(state.win_valid, pe_a) & take(state.win_valid, pe_b)
    sqrt_info = _odom_sqrt_info(cfg, f32, dev)

    # observations: the full (M, K) store flattened to O = M*K
    obs_valid = (state.wobs_valid & state.lm_valid[:, :, None]
                 & state.win_valid[:, None, :])
    nobs_win = torch.sum(obs_valid, dim=2)
    points_fixed = ~state.lm_valid | (nobs_win < 2)
    if not cfg.window_free_points:
        points_fixed = torch.ones_like(points_fixed)
    obs_mp = torch.arange(M, device=dev).repeat_interleave(K).expand(S, M * K)
    obs_kf = torch.arange(K, device=dev).repeat(M).expand(S, M * K)
    obs_w = torch.full((S, M), focal * cfg.obs_weight_scale, dtype=f32,
                       device=dev)
    if cfg.window_maturity_weight:
        obs_w = obs_w * torch.clamp(
            (state.lm_n_obs.to(f32) - 1.0) / cfg.maturity_ramp,
            cfg.maturity_floor, 1.0)
    eye4 = torch.eye(4, dtype=f32, device=dev)
    problem = ba.BAProblem(
        poses=state.win_pose_cw, pose_fixed=pose_fixed,
        points=state.lm_pos, points_fixed=points_fixed,
        obs_kf=obs_kf, obs_mp=obs_mp,
        obs_meas=state.wobs_meas.reshape(S, M * K, 2),
        obs_sqrt_info=obs_w.repeat_interleave(K, dim=1),
        obs_valid=obs_valid.reshape(S, M * K),
        pe_a=pe_a, pe_b=pe_b,
        pe_meas=take(state.win_odo, pe_b),
        pe_sqrt_info=sqrt_info.expand(S, K - 1, 6, 6),
        pe_valid=pe_valid,
        pr_idx=torch.zeros(S, 1, dtype=torch.int64, device=dev),
        pr_meas=eye4.expand(S, 1, 4, 4),
        pr_sqrt_info=torch.zeros(S, 1, 6, 6, dtype=f32, device=dev),
        pr_valid=torch.zeros(S, 1, dtype=torch.bool, device=dev))
    res = ba.lm_run(problem, cfg.window_ba_iters, ba.pick_cg_iters(K, M),
                    float(np.sqrt(ba.CHI2_THRESHOLD)), 1e-4)

    # a meaningful solve needs >= 2 window frames
    run = n_valid >= 2
    win_pose_cw = torch.where((run[:, None] & state.win_valid)[..., None, None],
                              res.poses, state.win_pose_cw)
    pose_cw = take(win_pose_cw, last[:, None])[:, 0]
    pt_updated = run[:, None] & ~points_fixed
    lm_pos = torch.where(pt_updated[..., None], res.points, state.lm_pos)
    # re-express the anchored parametrization around the BA'd position
    ray = lm_pos - state.lm_anchor_origin
    depth = torch.linalg.norm(ray, dim=-1)
    ok = pt_updated & (depth > 1e-6)
    lm_depth = torch.where(ok, depth, state.lm_depth)
    lm_anchor_ray = torch.where(
        ok[..., None], ray / torch.clamp(depth[..., None], min=1e-9),
        state.lm_anchor_ray)
    chi2 = res.obs_chi2.reshape(S, M, K)
    wobs_valid = state.wobs_valid & ((chi2 <= ba.CHI2_THRESHOLD)
                                     | ~run[:, None, None])
    run3 = run[:, None, None]
    return state._replace(
        pose_cw=torch.where(run3, pose_cw, state.pose_cw),
        prev_pose_cw=torch.where(run3, pose_cw, state.prev_pose_cw),
        win_pose_cw=win_pose_cw, lm_pos=lm_pos, lm_depth=lm_depth,
        lm_anchor_ray=lm_anchor_ray, wobs_valid=wobs_valid)


def make_vo_step(cfg: DeviceVOConfig, camera=None,
                 settings: Optional[StaticSettings] = None, device="cuda"):
    """Build the per-frame update ``step(state, image (S, H, W),
    odom_delta (S, 4, 4)) -> (state, VOStepOut)``. ``odom_delta`` is the
    odometry motion prior cam_t <- cam_{t-1}."""
    settings = _resolve_settings(cfg, settings)
    spec = _frontend_spec(settings, cfg.width, cfg.height)
    camera = _resolve_camera(cfg, camera)
    cam_kind, cam_params_np = pack_camera(camera)
    cam_params = torch.from_numpy(cam_params_np).to(device)
    focal = float(cam_params_np[0])
    loop_cb = None
    if cfg.loop_every > 0:
        loop_cb = torch.from_numpy(
            _loop_codebook(cfg.loop_words).view(np.int32)).to(device)

    def step(state: VOState, image, odom_delta):
        """One frame; inside a stamping chunk, each of ``STEP_STAGES``
        ends with a stamp."""
        pin_full_f32()
        S = image.shape[0]
        dev = image.device
        bS = torch.arange(S, device=dev)
        fidx = state.frame_idx
        txy = torch.zeros(S, N_TRACKED, 2, dtype=torch.float32, device=dev)
        tvalid = torch.zeros(S, N_TRACKED, dtype=torch.bool, device=dev)
        pts, octv, _, desc, feat_valid = extract(image.to(torch.float32),
                                                 txy, tvalid, spec)
        _stamp()
        N = pts.shape[1]
        pose_pred = odom_delta @ state.pose_cw

        # --- projection matching + pose-only BA
        nn_mf, matched = _match_map(state, pts, desc, feat_valid, pose_pred,
                                    cam_kind, cam_params, cfg)
        mb = unproject(cam_kind, cam_params, take(pts, nn_mf))
        meas = mb[..., :2] / torch.clamp(mb[..., 2:3], min=1e-6)
        have_map = torch.sum(matched, dim=1) >= 6
        # fresh two-view landmarks carry large depth uncertainty: weight
        # observations by landmark maturity
        maturity = torch.clamp(
            (state.lm_n_obs.to(torch.float32) - 1.0) / cfg.maturity_ramp,
            cfg.maturity_floor, 1.0)
        pose_opt = _pose_ba(state, pose_pred, meas, matched, cfg,
                            focal * cfg.obs_weight_scale * maturity)
        pose_cw = torch.where(have_map[:, None, None], pose_opt, pose_pred)
        _stamp()

        # --- landmark bookkeeping (matched is indexed by landmark row)
        lm_last_seen = torch.where(matched, fidx[:, None], state.lm_last_seen)
        lm_octave = torch.where(matched, take(octv, nn_mf), state.lm_octave)
        feat_claimed = torch.zeros(S, N, dtype=torch.int32, device=dev) \
            .scatter_reduce(1, nn_mf, matched.to(torch.int32), "amax") > 0
        free_cur = feat_valid & ~feat_claimed

        # --- anchored-depth refinement from this frame's re-observations
        lm_pos, lm_depth, lm_n_obs = _refine_depths(state, pose_cw, meas,
                                                    matched, cfg)
        mid = state._replace(lm_pos=lm_pos, lm_depth=lm_depth,
                             lm_n_obs=lm_n_obs, lm_last_seen=lm_last_seen)
        (lm_pos, lm_desc, lm_valid, lm_last_seen, lm_anchor_origin,
         lm_anchor_ray, lm_depth, lm_n_obs, assigned, new_slot,
         new_meas_cur, new_meas_prev) = _create_landmarks(
            mid, pose_cw, pts, desc, free_cur, cam_kind, cam_params, cfg)
        n_new = torch.sum(assigned, dim=1, dtype=torch.int32)
        lm_octave = _set_rows(lm_octave, new_slot, octv)
        lm_created = _set_rows(state.lm_created, new_slot,
                               fidx[:, None].expand(new_slot.shape))
        # creation-claimed features are no longer free
        free_cur = free_cur & ~assigned

        # --- staleness culling
        lm_valid = lm_valid & ((fidx[:, None] - lm_last_seen) <= cfg.stale_age)

        # --- sliding-window bookkeeping for the window BA
        win_pose_cw, win_valid, win_odo = (state.win_pose_cw,
                                           state.win_valid, state.win_odo)
        wobs_meas, wobs_valid = state.wobs_meas, state.wobs_valid
        if cfg.window > 0:
            K = cfg.window
            head = torch.remainder(fidx, K).to(torch.int64)
            prev_col = torch.remainder(fidx - 1, K).to(torch.int64)
            win_pose_cw = _set_slot(win_pose_cw, head, pose_cw)
            win_valid = _set_slot(win_valid, head, True)
            win_odo = _set_slot(win_odo, head, odom_delta)
            # the ring slot is recycled: overwrite its column with this
            # frame's re-observations
            wobs_valid = wobs_valid.clone()
            wobs_meas = wobs_meas.clone()
            wobs_valid[bS, :, head] = matched & lm_valid
            wobs_meas[bS, :, head] = meas
            # fresh landmarks: clear the recycled rows, then record both
            # creation observations (current + previous frame)
            wobs_valid = _set_rows(wobs_valid, new_slot, False)
            wobs_meas = _set_rows(wobs_meas, new_slot, new_meas_cur, col=head)
            wobs_valid = _set_rows(wobs_valid, new_slot, True, col=head)
            wobs_meas = _set_rows(wobs_meas, new_slot, new_meas_prev,
                                  col=prev_col)
            wobs_valid = _set_rows(wobs_valid, new_slot,
                                   (fidx > 0)[:, None].expand(new_slot.shape),
                                   col=prev_col)
        _stamp()

        # --- loop-candidate retrieval (BoW-index analogue)
        sig_ring, sig_frame = state.sig_ring, state.sig_frame
        sig_pc, sig_desc = state.sig_pc, state.sig_desc
        sig_obs, sig_pvalid = state.sig_obs, state.sig_pvalid
        sig_pose, sig_octave = state.sig_pose, state.sig_octave
        loop_frame = torch.full((S,), -1, dtype=torch.int32, device=dev)
        loop_score = torch.zeros(S, dtype=torch.float32, device=dev)
        if cfg.loop_every > 0:
            # quantise every sequence's descriptors in ONE kernel launch
            _, words = hamming_argmin(desc.reshape(S * N, 8), loop_cb)
            words = words.reshape(S, N).to(torch.int64)
            hist = torch.zeros(S, cfg.loop_words, dtype=torch.float32,
                               device=dev).scatter_add_(
                1, words, feat_valid.to(torch.float32))
            # sqrt damps word burstiness on repeated texture
            hist = torch.sqrt(hist)
            sig = hist / torch.clamp(torch.linalg.norm(hist, dim=1,
                                                       keepdim=True), min=1e-6)
            # query the ring BEFORE storing, with the time gate
            scores = (sig_ring @ sig[..., None])[..., 0]
            eligible = ((sig_frame >= 0)
                        & (fidx[:, None] - sig_frame >= cfg.loop_min_gap))
            ring_span = cfg.loop_slots * cfg.loop_every
            if ring_span > cfg.loop_stale_guard:
                eligible &= (sig_frame > fidx[:, None]
                             - (ring_span - cfg.loop_stale_guard))
            scores = torch.where(eligible, scores, torch.full_like(scores, -1.0))
            best = torch.argmax(scores, dim=1, keepdim=True)
            loop_score = torch.gather(scores, 1, best)[:, 0]
            loop_frame = torch.where(loop_score >= cfg.loop_min_score,
                                     torch.gather(sig_frame, 1, best)[:, 0],
                                     torch.full_like(loop_frame, -1))
            # store at the static cadence
            store = torch.remainder(fidx, cfg.loop_every) == 0
            slot = torch.remainder(torch.div(fidx, cfg.loop_every,
                                             rounding_mode="floor"),
                                   cfg.loop_slots).to(torch.int64)

            def put(ring, value):
                old = ring[bS, slot]
                st = store.reshape((S,) + (1,) * (old.dim() - 1))
                return _set_slot(ring, slot, torch.where(st, value, old))

            sig_ring = put(sig_ring, sig)
            sig_frame = put(sig_frame, fidx)
            # snapshot the frame's observed live landmarks (matched or
            # created this frame) for the host closure stack, compacted with
            # one stable argsort gather
            P = cfg.loop_points
            pc_cam = _transform(pose_cw, lm_pos)
            _, snap_vis = project(cam_kind, cam_params, pc_cam)
            created_now = _set_rows(torch.zeros_like(lm_valid), new_slot, True)
            snap_sel = (lm_valid & snap_vis & (pc_cam[..., 2] > 1e-6)
                        & (matched | created_now))
            order = torch.argsort(-snap_sel.to(torch.int32), dim=1,
                                  stable=True)[:, :P]
            zsafe = torch.clamp(pc_cam[..., 2:3], min=1e-6)
            obs_created = _set_rows(torch.zeros_like(meas), new_slot,
                                    new_meas_cur)
            snap_obs = torch.where((matched & snap_sel)[..., None], meas,
                                   torch.where(created_now[..., None],
                                               obs_created,
                                               pc_cam[..., :2] / zsafe))
            sig_pc = put(sig_pc, take(pc_cam, order))
            sig_desc = put(sig_desc, take(lm_desc, order))
            sig_obs = put(sig_obs, take(snap_obs, order))
            sig_pvalid = put(sig_pvalid, take(snap_sel, order))
            sig_pose = put(sig_pose, pose_cw)
            sig_octave = put(sig_octave, take(lm_octave, order))

        new_state = VOState(
            pose_cw=pose_cw, lm_pos=lm_pos, lm_desc=lm_desc,
            lm_valid=lm_valid, lm_last_seen=lm_last_seen,
            lm_anchor_origin=lm_anchor_origin, lm_anchor_ray=lm_anchor_ray,
            lm_depth=lm_depth, lm_n_obs=lm_n_obs,
            lm_octave=lm_octave, lm_created=lm_created,
            prev_pts=pts, prev_desc=desc, prev_free=free_cur,
            prev_pose_cw=pose_cw, frame_idx=fidx + 1,
            win_pose_cw=win_pose_cw, win_valid=win_valid, win_odo=win_odo,
            wobs_meas=wobs_meas, wobs_valid=wobs_valid,
            sig_ring=sig_ring, sig_frame=sig_frame,
            sig_pc=sig_pc, sig_desc=sig_desc, sig_obs=sig_obs,
            sig_pvalid=sig_pvalid, sig_pose=sig_pose,
            sig_octave=sig_octave)
        out = VOStepOut(
            pose_cw=pose_cw,
            n_matched=torch.sum(matched, dim=1, dtype=torch.int32),
            n_new=n_new, loop_frame=loop_frame.to(torch.int32),
            loop_score=loop_score)
        _stamp()
        return new_state, out

    return step, spec


def _rebase_states(state: VOState, T: torch.Tensor, apply: torch.Tensor,
                   cand_frame: torch.Tensor,
                   cand_slot: Optional[torch.Tensor] = None,
                   slot_T: Optional[torch.Tensor] = None,
                   slot_frame: Optional[torch.Tensor] = None,
                   merge_radius: float = 0.0,
                   merge: bool = False) -> VOState:
    """Apply per-sequence loop-closure corrections to the batched state: the
    device path's ``correctLoop`` (reference: loop_closer.cpp:405-591), as
    one run of batched ops with no host sync. Out of place: returns a new
    ``VOState`` and leaves ``state`` (and every tensor a caller holds from
    earlier chunks) as it was.

    ``T`` (S, 4, 4) is the SE3 world correction, right-multiplied onto the
    poses; landmarks created after ``cand_frame`` (S,) move by ``T^-1`` so
    their camera-frame coordinates are kept, older ones stay put. Ring slot
    r of sequence s uses ``slot_T[s, r]`` when its stored frame equals
    ``slot_frame[s, r]`` (the host's interpolated smear), else the rigid
    predicate ``sig_frame > cand_frame -> T``. ``merge`` (a Python bool)
    adds the duplicate-landmark merge of :func:`_merge_duplicates` within
    ``merge_radius`` metres, against ring slot ``cand_slot`` (S,).
    ``apply`` (S,) bool: a sequence without an accepted closure comes out
    bit-identical."""
    pin_full_f32()
    S, R_sig = state.sig_pose.shape[:2]
    dev = T.device
    if cand_slot is None:
        cand_slot = torch.zeros(S, dtype=torch.int64, device=dev)
    if slot_T is None:
        slot_T = torch.eye(4, dtype=torch.float32, device=dev).expand(
            S, R_sig, 4, 4)
        slot_frame = torch.full((S, R_sig), -2, dtype=torch.int32,
                                device=dev)
    on = apply.to(torch.bool)
    cf = cand_frame.to(torch.int32)[:, None]
    Tinv = lie.se3_inverse(T)
    Rinv_t = Tinv[:, :3, :3].transpose(-1, -2)
    tinv = Tinv[:, None, :3, 3]
    corrected = state.lm_valid & (state.lm_created > cf)
    on3 = on[:, None, None]

    def point(p, move):
        return torch.where((on[:, None] & move)[..., None],
                           p @ Rinv_t + tinv, p)

    eye = torch.eye(4, dtype=T.dtype, device=dev)
    rigid = torch.where((state.sig_frame > cf)[..., None, None],
                        T[:, None], eye)
    Tr = torch.where((state.sig_frame == slot_frame)[..., None, None],
                     slot_T, rigid)
    st = state._replace(
        pose_cw=torch.where(on3, state.pose_cw @ T, state.pose_cw),
        prev_pose_cw=torch.where(on3, state.prev_pose_cw @ T,
                                 state.prev_pose_cw),
        win_pose_cw=torch.where(on3[..., None], state.win_pose_cw @ T[:, None],
                                state.win_pose_cw),
        lm_pos=point(state.lm_pos, corrected),
        lm_anchor_origin=point(state.lm_anchor_origin, corrected),
        lm_anchor_ray=torch.where((on[:, None] & corrected)[..., None],
                                  state.lm_anchor_ray @ Rinv_t,
                                  state.lm_anchor_ray),
        sig_pose=torch.where(on3[..., None], state.sig_pose @ Tr,
                             state.sig_pose))
    if not merge:
        return st
    return _merge_duplicates(st, on, cf, cand_slot.to(torch.int64),
                             merge_radius)


def _scatter_rows(base: torch.Tensor, tgt: torch.Tensor, src: torch.Tensor,
                  reduce: str) -> torch.Tensor:
    """``base.at[tgt].add/max(src, mode="drop")`` per sequence: base (S, M,
    ...), tgt (S, M) in [0, M], src like base; row M is a scratch row that
    is dropped."""
    S, M = base.shape[:2]
    ext = torch.cat([base, base[:, :1]], dim=1)
    idx = tgt.reshape((S, M) + (1,) * (base.dim() - 2)).expand(src.shape)
    if reduce == "sum":
        return ext.scatter_add(1, idx, src)[:, :M]
    return ext.scatter_reduce(1, idx, src, reduce="amax",
                              include_self=True)[:, :M]


def _merge_duplicates(st: VOState, on, cf, cslot, radius: float) -> VOState:
    """Post-closure duplicate-landmark hygiene (searchAndDeduplicate and the
    map-point merge, loop_closer.cpp:531-591), batched over S. ``on`` (S,),
    ``cf`` (S, 1), ``cslot`` (S,).

    Stage 1: a corrected-region landmark that is the Hamming mutual-NN of a
    surviving old-region one within ``radius`` is freed, and its observation
    count, last-seen frame and window observations move into the older
    slot. Stage 2: the remaining corrected-region landmarks snap onto the
    candidate snapshot's points they match. The M x M and M x P distances
    are plain torch."""
    S, M = st.lm_pos.shape[:2]
    b = torch.arange(S, device=st.lm_pos.device)
    # the reference squares the radius in float32
    r2 = float(np.float32(radius) * np.float32(radius))
    new_mask = st.lm_valid & (st.lm_created > cf)
    old_mask = st.lm_valid & (st.lm_created <= cf) & (st.lm_created >= 0)

    # stage 1: merge into the older landmark, keep its position
    dist = hamming_matrix(st.lm_desc, st.lm_desc)             # (S, M, M)
    d2 = torch.sum((st.lm_pos[:, :, None, :] - st.lm_pos[:, None, :, :]) ** 2,
                   dim=-1)
    gate = new_mask[:, :, None] & old_mask[:, None, :] & (d2 <= r2)
    dist = torch.where(gate, dist, torch.full_like(dist, MASK_DIST))
    nn, ok = mutual_nn(dist, HAMMING_DIST_THR_LOW)
    ok = ok & on[:, None]
    tgt = torch.where(ok, nn, torch.full_like(nn, M))
    lm_valid = st.lm_valid & ~ok
    lm_n_obs = _scatter_rows(st.lm_n_obs, tgt,
                             torch.where(ok, st.lm_n_obs, 0), "sum")
    lm_last_seen = _scatter_rows(st.lm_last_seen, tgt,
                                 torch.where(ok, st.lm_last_seen, -1), "amax")
    # window observations of the freed duplicate go to the kept slot (the
    # columns where it has none); the boolean max runs on uint8
    moved = st.wobs_valid & ok[..., None]
    add_valid = _scatter_rows(torch.zeros_like(st.wobs_valid,
                                               dtype=torch.uint8),
                              tgt, moved.to(torch.uint8), "amax") > 0
    add_meas = _scatter_rows(torch.zeros_like(st.wobs_meas), tgt,
                             torch.where(moved[..., None], st.wobs_meas, 0.0),
                             "sum")
    take_new = add_valid & ~st.wobs_valid
    wobs_meas = torch.where(take_new[..., None], add_meas, st.wobs_meas)
    # the reference also clears here the stale window bits of landmarks
    # culled earlier in sequences without a closure; no reader sees those
    # bits (the window BA masks by lm_valid, slot reuse clears the row), and
    # keeping them leaves such a sequence bit-identical
    wobs_valid = torch.where(on[:, None, None],
                             (st.wobs_valid | add_valid) & lm_valid[..., None],
                             st.wobs_valid)

    # stage 2: snap onto the candidate snapshot's (old-lap) geometry
    snap_pc = st.sig_pc[b, cslot]                             # (S, P, 3) cam
    snap_desc = st.sig_desc[b, cslot]
    snap_valid = st.sig_pvalid[b, cslot]
    pose_c = st.sig_pose[b, cslot]
    Rc, tc = pose_c[:, :3, :3], pose_c[:, None, :3, 3]
    p_w = (snap_pc - tc) @ Rc                                 # R^T (p - t)
    dist2 = hamming_matrix(st.lm_desc, snap_desc)             # (S, M, P)
    d2s = torch.sum((st.lm_pos[:, :, None, :] - p_w[:, None, :, :]) ** 2,
                    dim=-1)
    gate2 = ((new_mask & lm_valid & ~ok)[:, :, None] & snap_valid[:, None, :]
             & (d2s <= r2))
    dist2 = torch.where(gate2, dist2, torch.full_like(dist2, MASK_DIST))
    nn2, ok2 = mutual_nn(dist2, HAMMING_DIST_THR_LOW)
    ok2 = ok2 & on[:, None]
    lm_pos = torch.where(ok2[..., None], take(p_w, nn2), st.lm_pos)
    ray = lm_pos - st.lm_anchor_origin
    depth = torch.linalg.norm(ray, dim=-1)
    upd = ok2 & (depth > 1e-6)
    lm_depth = torch.where(upd, depth, st.lm_depth)
    lm_anchor_ray = torch.where(
        upd[..., None], ray / torch.clamp(depth[..., None], min=1e-9),
        st.lm_anchor_ray)
    return st._replace(lm_valid=lm_valid, lm_n_obs=lm_n_obs,
                       lm_last_seen=lm_last_seen, lm_pos=lm_pos,
                       lm_depth=lm_depth, lm_anchor_ray=lm_anchor_ray,
                       wobs_meas=wobs_meas, wobs_valid=wobs_valid)


def _cat_shards(parts, device):
    """Concatenate per-shard NamedTuples of tensors along the batch on
    ``device`` (one shard: returned as it is)."""
    if len(parts) == 1:
        return parts[0]
    return type(parts[0])(*(torch.cat([t.to(device) for t in ts])
                            for ts in zip(*parts)))


def loop_candidates(out: VOStepOut, frame_offset: int = 0) -> np.ndarray:
    """(N, 4) rows [sequence, query_frame, candidate_frame, score] for every
    frame of one ``advance`` output that reported a candidate.
    ``frame_offset`` shifts the query column only (``loop_frame`` is already
    session-absolute)."""
    lf = out.loop_frame.cpu().numpy()
    ls = out.loop_score.cpu().numpy()
    if lf.ndim == 1:
        lf, ls = lf[None], ls[None]
    seq, t = np.nonzero(lf >= 0)
    return np.stack([seq.astype(np.float64), t + float(frame_offset),
                     lf[seq, t].astype(np.float64), ls[seq, t]], axis=1)


def init_state(cfg: DeviceVOConfig, num_slots: int, batch: int = 1,
               device="cuda") -> VOState:
    """Empty state for ``batch`` sequences, all at the identity pose."""
    M = cfg.lm_capacity
    if cfg.loop_every > 0:
        assert cfg.loop_points <= cfg.lm_capacity, (
            f"loop_points={cfg.loop_points} exceeds lm_capacity="
            f"{cfg.lm_capacity}: the snapshot compaction gathers at most "
            "lm_capacity landmark rows per ring slot")
    K = max(cfg.window, 1)
    R = cfg.loop_slots if cfg.loop_every > 0 else 1
    W = cfg.loop_words if cfg.loop_every > 0 else 1
    P = cfg.loop_points if cfg.loop_every > 0 else 1
    S = batch
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    eye4 = torch.eye(4, dtype=f32, device=device)

    def z(*shape, dtype=f32):
        return torch.zeros((S,) + shape, dtype=dtype, device=device)

    def full(value, *shape):
        return torch.full((S,) + shape, value, dtype=i32, device=device)

    def eyes(n):
        return eye4.expand(S, n, 4, 4).clone()

    return VOState(
        pose_cw=eye4.expand(S, 4, 4).clone(),
        lm_pos=z(M, 3), lm_desc=z(M, 8, dtype=i32), lm_valid=z(M, dtype=b8),
        lm_last_seen=full(-1, M), lm_anchor_origin=z(M, 3),
        lm_anchor_ray=z(M, 3), lm_depth=z(M), lm_n_obs=z(M, dtype=i32),
        lm_octave=z(M, dtype=i32), lm_created=full(-1, M),
        prev_pts=z(num_slots, 2), prev_desc=z(num_slots, 8, dtype=i32),
        prev_free=z(num_slots, dtype=b8),
        prev_pose_cw=eye4.expand(S, 4, 4).clone(),
        frame_idx=z(dtype=i32),
        win_pose_cw=eyes(K), win_valid=z(K, dtype=b8), win_odo=eyes(K),
        wobs_meas=z(M, K, 2), wobs_valid=z(M, K, dtype=b8),
        sig_ring=z(R, W), sig_frame=full(-1, R),
        sig_pc=z(R, P, 3), sig_desc=z(R, P, 8, dtype=i32),
        sig_obs=z(R, P, 2), sig_pvalid=z(R, P, dtype=b8),
        sig_pose=eyes(R), sig_octave=z(R, P, dtype=i32))


def state_from_numpy(fields: Mapping[str, np.ndarray],
                     device="cuda") -> VOState:
    """Port state from the JAX package's batched VOState as NumPy arrays
    (a dict, or the ``.npz`` that ``BatchedDeviceVO.save_state`` writes in
    either package). uint32 descriptor fields become int32 bit patterns."""
    leaves = []
    for name in VOState._fields:
        a = np.asarray(fields[name])
        if name in _DESC_FIELDS:
            a = np.ascontiguousarray(a, np.uint32).view(np.int32)
        leaves.append(torch.from_numpy(np.array(a)).to(device))
    return VOState(*leaves)


def state_to_numpy(state: VOState) -> dict:
    """Inverse of :func:`state_from_numpy`: field name -> NumPy array, with
    the descriptor fields as uint32 like the JAX package's state."""
    out = {}
    for name, t in zip(VOState._fields, state):
        a = t.detach().cpu().numpy()
        if name in _DESC_FIELDS:
            a = a.view(np.uint32)
        out[name] = a
    return out

def _chunk_snaps(cfg: DeviceVOConfig, st: VOState, f0: torch.Tensor,
                 T: int) -> Optional[SnapOut]:
    """Ring rows stored during the chunk that started at frames ``f0``
    (S,): the multiples of loop_every in [f0, f0 + T), exactly T //
    loop_every of them."""
    if cfg.loop_every <= 0:
        return None
    le = cfg.loop_every
    assert T % le == 0, (
        f"chunk length {T} not divisible by loop_every={le}: "
        "the snapshot mirror needs a static stored-slot count")
    first = torch.div(f0 + le - 1, le, rounding_mode="floor")
    idx = first[:, None] + torch.arange(T // le, device=f0.device)
    slots = torch.remainder(idx, cfg.loop_slots).to(torch.int64)
    return SnapOut(slot=slots, frame=take(st.sig_frame, slots),
                   pc=take(st.sig_pc, slots), desc=take(st.sig_desc, slots),
                   obs=take(st.sig_obs, slots),
                   pvalid=take(st.sig_pvalid, slots),
                   pose=take(st.sig_pose, slots),
                   octave=take(st.sig_octave, slots))


def _copy_fields(dst, src) -> None:
    """Copy a NamedTuple of tensors into buffers of the same shapes and
    dtypes. A mismatch raises before anything is copied: ``copy_`` would
    broadcast or convert."""
    for name, d, s in zip(dst._fields, dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"{name}: got {tuple(s.shape)} {s.dtype}, the "
                             f"buffer holds {tuple(d.shape)} {d.dtype}")
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def _clone(nt):
    return type(nt)(*(t.clone() for t in nt))


class _Shape:
    """The fixed buffers of one chunk shape: the inputs (S, T, H, W) and
    (S, T, 4, 4), the stacked outputs and snapshot rows, and the chunk's
    stage stamps (``stamp_stages``); ``warm`` once a chunk ran eagerly
    through them."""

    def __init__(self, images: torch.Tensor, odom: torch.Tensor,
                 n_stamps: int, device):
        self.images = torch.empty(images.shape, dtype=images.dtype,
                                  device=device)
        self.odom = torch.empty(odom.shape, dtype=torch.float32,
                                device=device)
        self.stamps = torch.zeros(n_stamps, dtype=torch.int64,
                                  device=device)
        self.out: Optional[VOStepOut] = None
        self.snaps: Optional[SnapOut] = None
        self.warm = False


def _copy_in(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Host or device tensor into a fixed input buffer; from the host
    through pinned memory, without waiting for the card."""
    if dst.shape != src.shape:
        raise ValueError(f"chunk input {tuple(src.shape)} does not fit the "
                         f"buffer {tuple(dst.shape)}")
    if dst.is_cuda and not src.is_cuda:
        pinned = torch.empty(src.shape, dtype=dst.dtype, pin_memory=True)
        pinned.copy_(src)
        dst.copy_(pinned, non_blocking=True)
    else:
        dst.copy_(src)


class _ChunkGraph:
    """One shard's chunk program, the counterpart of the JAX package's
    ``jax.jit(jax.vmap(chunk))``: T frame steps with a window BA after
    every ``window_ba_every`` of them, then the snapshot rows, over fixed
    buffers. ``self.state`` holds the shard's state and every chunk updates
    it in place; each chunk shape (T, H, W) has its own input and output
    buffers (:class:`_Shape`, kept beside the shape's entry of
    ``self.graphs``).

    The chunk runs eagerly on the CPU, for the first chunk of a shape on a
    card (the warm-up that fills the cached device constants, the BLAS
    handles and the kernel's build), and whenever the caller asks for the
    eager twin. From the second chunk of a shape on a card it is one CUDA
    graph of ``self.graphs`` (``ops/graphs``: captured on a side stream in
    the global mode into this shard's private memory pool, replayed on the
    current stream, its K1 and GFTT launches counted per replay)."""

    def __init__(self, step, cfg: DeviceVOConfig, focal: float,
                 state: VOState):
        self._step = step
        self.cfg = cfg
        self._focal = focal
        self.state = state
        self.device = state.pose_cw.device
        self.graphs = GraphCache("vo", pool="cache", lock=None,
                                 capture_error_mode="global", warm_up=False)

    def chunk(self, state: VOState, images: torch.Tensor,
              odom: torch.Tensor, stamps: Optional[torch.Tensor] = None):
        """The chunk as a function: (state, (S, T, H, W), (S, T, 4, 4)) ->
        (state, VOStepOut stacked to (S, T, ...), SnapOut or None). No
        value is read back to the host. With ``stamps`` (int64, one more
        slot than ``stamp_stages(cfg, T)``), the chunk stamps its start and
        the end of each of those stages into it, in stream order."""
        cfg = self.cfg
        T = images.shape[1]
        G = cfg.window_ba_every
        if cfg.window > 0:
            assert T % G == 0, (
                f"chunk length {T} not divisible by window_ba_every={G}")
        outer = getattr(_STAMP, "stamper", None)
        _STAMP.stamper = Stamper(stamps) if stamps is not None else None
        try:
            _stamp()
            f0 = state.frame_idx
            outs = []
            for t in range(T):
                state, out = self._step(state, images[:, t], odom[:, t])
                outs.append(out)
                if cfg.window > 0 and (t + 1) % G == 0:
                    state = _window_ba(state, cfg, self._focal)
                    _stamp()
            out = VOStepOut(*(torch.stack(x, dim=1) for x in zip(*outs)))
            snaps = _chunk_snaps(cfg, state, f0, T)
            _stamp()
        finally:
            _STAMP.stamper = outer
        return state, out, snaps

    def load(self, state: VOState) -> None:
        """Copy ``state`` into this shard's state buffers."""
        _copy_fields(self.state, state)

    def _run_into(self, b: _Shape) -> None:
        st, out, snaps = self.chunk(self.state, b.images, b.odom,
                                    stamps=b.stamps)
        if b.out is None:                    # eager, never inside a capture
            b.out = VOStepOut(*(torch.empty_like(t) for t in out))
            if snaps is not None:
                b.snaps = SnapOut(*(torch.empty_like(t) for t in snaps))
        _copy_fields(b.out, out)
        if snaps is not None:
            _copy_fields(b.snaps, snaps)
        _copy_fields(self.state, st)

    def run(self, images: torch.Tensor, odom: torch.Tensor,
            replay: bool) -> _Shape:
        """Copy one chunk's inputs in and run it (replayed where it can be
        and ``replay`` is set); the results are in the returned buffers and
        ``self.state`` until the next chunk of the same shape."""
        S, T, H, W = images.shape
        e, first = self.graphs.entry((tuple(images.shape), images.dtype),
                                     dict(S=S, T=T, H=H, W=W))
        if first:
            e.own = _Shape(images, odom,
                           len(stamp_stages(self.cfg, T)) + 1, self.device)
        b = e.own
        with self.graphs.hold(e, self.device):
            with timer.section("vo.copy_in"):
                _copy_in(b.images, images)
                _copy_in(b.odom, odom)
            if self.device.type == "cuda" and replay and b.warm:
                self.graphs.run(e, lambda: self._run_into(b), self.device)
            else:
                self.graphs.eager(self._run_into, b)
                b.warm = True
        return b


class BatchedDeviceVO:
    """S sequences x T frames per ``advance``; the state stays on
    ``device`` between calls.

    On a card ``advance`` replays one CUDA graph per shard and chunk shape,
    the counterpart of the JAX package's one-dispatch chunk: the first
    chunk of a shape runs eagerly as the warm-up, the second captures the
    graph, and every later one replays it (see :class:`_ChunkGraph`). On
    the CPU the same buffers are filled eagerly. The outputs, ``last_snaps``
    and ``state`` are copies that no later chunk changes; setting ``state``,
    ``reset`` and ``load_state`` copy into the buffers the graph reads.

    Multi-device: pass ``mesh`` (``parallel/mesh.make_mesh``; its first
    axis is the data axis) to split the S sequences over its devices. Each
    shard keeps its own state and graph on its device; ``advance`` enqueues
    every shard's chunk before it waits on any and concatenates the outputs
    on the first shard's device, which is then ``self.device``. Sequences
    are independent, so no cross-device math is needed. ``state`` reads
    back as one :class:`VOState` and takes one when set, so ``DeviceSlam``
    and the checkpoints see no difference."""

    def __init__(self, cfg: DeviceVOConfig, batch: int, camera=None,
                 settings: Optional[StaticSettings] = None, device="cuda",
                 mesh=None):
        self.cfg = cfg
        self.batch = batch
        if mesh is None:
            shard_devices = [torch.device(device)]
        else:
            from slam_tpu_torch.parallel.mesh import batch_sharding

            axis = mesh.axis_names[0]
            assert batch % mesh.shape[axis] == 0, (
                f"batch {batch} not divisible by mesh axis "
                f"'{axis}'={mesh.shape[axis]}")
            shard_devices = batch_sharding(mesh, axis).devices
        self.shard_devices = shard_devices
        self.device = shard_devices[0]
        camera = _resolve_camera(cfg, camera)
        settings = _resolve_settings(cfg, settings)
        if cfg.window:
            assert cfg.window >= 2, "window needs >= 2 frames"
            assert cfg.window_ba_every >= 1
        # one step per distinct device: the step holds its constants there
        steps = {}
        for dev in shard_devices:
            if dev not in steps:
                steps[dev], spec = make_vo_step(
                    cfg, camera=camera, settings=settings, device=dev)
        self.num_slots = N_TRACKED + sum(spec.budgets)
        self._focal = float(pack_camera(camera)[1][0])
        n = len(shard_devices)
        self._chunks = [_ChunkGraph(steps[dev], cfg, self._focal,
                                    init_state(cfg, self.num_slots,
                                               batch // n, dev))
                        for dev in shard_devices]
        self.reset()

    @property
    def last_stamps(self) -> Optional[torch.Tensor]:
        """The last chunk's stage stamps, (shards, len(stamp_stages) + 1)
        int64 on ``self.device``: a copy, enqueued behind that chunk, of
        what it wrote (ns on each shard device's clock; ``perf_counter_ns``
        on the CPU); ``stamp_stages(cfg, T)`` names the work between two
        neighbours. None before the first chunk."""
        if self._last is None:
            return None
        return torch.cat([b.stamps[None].to(self.device, copy=True)
                          for b in self._last])

    @property
    def state(self) -> VOState:
        """A copy of the whole batch's state on ``self.device``; later
        chunks do not change it."""
        return _cat_shards([_clone(c.state) for c in self._chunks],
                           self.device)

    @state.setter
    def state(self, state: VOState) -> None:
        n = len(self._chunks)
        parts = zip(*(torch.chunk(t, n) for t in state))
        for c, part in zip(self._chunks, parts):
            c.load(VOState(*part))

    def reset(self, poses0_cw: Optional[np.ndarray] = None):
        """Re-initialize all sequence states, optionally at (S, 4, 4)
        world->camera start poses."""
        n = len(self._chunks)
        parts = [None] * n
        if poses0_cw is not None:
            parts = torch.chunk(torch.as_tensor(
                np.asarray(poses0_cw, np.float32)), n)
        for c, part in zip(self._chunks, parts):
            fresh = init_state(self.cfg, self.num_slots, self.batch // n,
                               c.device)
            if part is not None:
                part = part.to(c.device)
                fresh = fresh._replace(pose_cw=part, prev_pose_cw=part.clone())
            c.load(fresh)
        self.last_snaps = None
        self._last = None

    def advance(self, images, odom_deltas) -> VOStepOut:
        """images: (S, T, H, W) uint8; odom_deltas: (S, T, 4, 4). Returns
        per-frame outputs stacked to (S, T, ...). With loop detection on,
        the ring rows stored during the chunk are in ``self.last_snaps``.
        On a card the chunk is a replayed CUDA graph from the second chunk
        of a shape on."""
        return self._advance(images, odom_deltas, replay=True)

    def _advance_eager(self, images, odom_deltas) -> VOStepOut:
        """:meth:`advance` with every op issued from Python: the graph's
        twin, for comparison and for profiles by stage."""
        return self._advance(images, odom_deltas, replay=False)

    @timer.timed_as("vo.advance")
    def _advance(self, images, odom_deltas, replay: bool) -> VOStepOut:
        n = len(self._chunks)
        images = torch.chunk(torch.as_tensor(images), n)
        odom = torch.chunk(torch.as_tensor(np.asarray(odom_deltas,
                                                      np.float32)), n)
        # every shard's chunk is enqueued before any result is read
        shapes = [c.run(x, d, replay)
                  for c, x, d in zip(self._chunks, images, odom)]
        self._last = shapes
        self.last_snaps = None if shapes[0].snaps is None else _cat_shards(
            [_clone(b.snaps) for b in shapes], self.device)
        return _cat_shards([_clone(b.out) for b in shapes], self.device)

    def save_state(self, path: str) -> None:
        """Checkpoint the session state to an ``.npz`` with the JAX
        package's field names and dtypes."""
        np.savez_compressed(path, **state_to_numpy(self.state))

    def load_state(self, path: str) -> None:
        """Resume from :meth:`save_state` output of either package; the
        checkpoint must match this instance's (cfg, batch) capacities."""
        with np.load(path) as z:
            fields = {f: z[f] for f in VOState._fields}
        for name, cur in zip(VOState._fields, self.state):
            assert tuple(cur.shape) == fields[name].shape, (
                f"checkpoint field {name}: shape {fields[name].shape} != "
                f"session capacity {tuple(cur.shape)}")
        self.state = state_from_numpy(fields, self.device)
