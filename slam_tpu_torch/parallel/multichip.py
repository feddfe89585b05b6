"""Multi-device update step over the production kernels (port of
slam_tpu/parallel/multichip.py).

Scope note, as in the reference: the step exercises every production
kernel family on a batch of frame pairs split over a mesh, but its
per-frame SEMANTICS are a demo shape: frames matched to their rolled
neighbours, mutual-NN instead of the greedy one-to-one matchers, a fixed
2-pose BA, and degenerate-input fallbacks that fabricate matches so tiny
random inputs still exercise the solvers. The production multi-device path
is ``pipeline/device_vo.BatchedDeviceVO`` with ``mesh=``.

One update step covers every dense stage of the SLAM pipeline for a BATCH
of frame pairs, built from the functions the one-device pipeline runs:

  - the ORB front-end (`ops/frontend.extract`: pyramid, detector, IC
    angle, rotated BRIEF),
  - dense Hamming matching (`ops/hamming.hamming_matrix`, `mutual_nn`),
  - essential-matrix RANSAC over bearings
    (`ops/ransac.essential_ransac_core`),
  - pose recovery and two-view triangulation from the step's own matches
    (`ops/ransac.recover_pose_from_E`),
  - Sim3 RANSAC over the triangulated point sets
    (`ops/ransac.sim3_ransac_core`),
  - one bundle-adjustment LM solve over each pair's own poses, points and
    observations (`ops/ba.lm_run`, the production solver).

Frames ride the mesh's ``data`` axis: each shard's B pairs run as one
batch on its device (every stage above takes a leading batch dimension),
and the shards are enqueued one after another without waiting. Frame b is
matched with frame (b + 1) mod B; the last frame of a shard pairs with the
first frame of the next shard, whose features are copied across devices
explicitly (the JAX package's roll, where GSPMD inserted a permute). Both
RANSAC hypothesis banks come from a sampler (default
:func:`make_sampler`; the tests inject the JAX package's banks).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from slam_tpu_torch.ops import ba
from slam_tpu_torch.ops import camera as camera_ops
from slam_tpu_torch.ops.frontend import FrontendSpec, extract, min_distances
from slam_tpu_torch.ops.hamming import (HAMMING_DIST_THR_LOW, MASK_DIST,
                                        hamming_matrix, mutual_nn)
from slam_tpu_torch.ops.pyramid import level_sizes
from slam_tpu_torch.ops.ransac import (essential_ransac_core,
                                       recover_pose_from_E,
                                       sample_hypotheses, sim3_ransac_core)
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.precision import pin_full_f32

# sampler(valid (b, N) bool, size 8 or 3, pairs (b,) global pair indices)
# -> (b, K, size) int64 match indices on valid's device
Sampler = Callable[[torch.Tensor, int, np.ndarray], torch.Tensor]
N_TRACKED = 8  # no LK tracks in the batched offline path; slots masked off


class MultichipStep(NamedTuple):
    keypoints: torch.Tensor        # (B, N, 2) detected keypoints
    descriptors: torch.Tensor      # (B, N, 8) int32 ORB descriptor bits
    essential_inliers: torch.Tensor  # (B,) inlier counts of the E-RANSAC
    sim3_inliers: torch.Tensor     # (B,) inlier counts of the Sim3 RANSAC
    poses: torch.Tensor            # (B, 2, 4, 4) BA-refined pair poses
    points: torch.Tensor           # (B, M, 3) BA-refined triangulated points
    ba_cost: torch.Tensor          # (B,) final BA cost


def _mutual_match(desc_a, desc_b, valid_a, valid_b):
    """Dense mutual-nearest matching with the production distance kernel,
    batched over leading dims: THR_LOW acceptance and mutual consistency in
    place of the greedy host matchers' sequential one-to-one claim
    (keyframe_matcher.cpp:160-293)."""
    dist = hamming_matrix(desc_a, desc_b)
    dist = torch.where(valid_a[..., :, None] & valid_b[..., None, :], dist,
                       torch.full_like(dist, MASK_DIST))
    nn_ab, ok = mutual_nn(dist, HAMMING_DIST_THR_LOW)
    return nn_ab, valid_a & ok


def pair_chain(feats_a, feats_b, sample_ess, sample_sim3, cam_kind,
               cam_params, ba_capacity: int, ba_iterations: int):
    """The dense chain for a batch of b frame pairs (the reference's
    ``_pair_step_impl``). ``feats_*`` are (pts (b, N, 2), valid (b, N),
    desc (b, N, 8)); ``sample_ess(valid)`` and ``sample_sim3(valid)``
    return the (b, K, 8) and (b, K, 3) hypothesis banks. Returns
    (essential inlier counts, Sim3 inlier counts, BA poses, BA points, BA
    cost). The caller pins full f32."""
    pts_a, valid_a, desc_a = feats_a
    pts_b, valid_b, desc_b = feats_b
    B, N = valid_a.shape
    dt, dev = pts_a.dtype, pts_a.device

    nn, real_good = _mutual_match(desc_a, desc_b, valid_a, valid_b)
    # degenerate-input guard: with < 8 matches the pair carries no usable
    # geometry, but the sampling distribution must stay well-defined;
    # reported inlier counts are masked back to the REAL matches below
    degenerate = torch.sum(real_good, dim=-1) < 8
    good = torch.where(degenerate[:, None], torch.ones_like(real_good),
                       real_good)
    pix_b = torch.take_along_dim(pts_b, nn[..., None], dim=-2)
    b1 = camera_ops.unproject(cam_kind, cam_params, pts_a)
    b2 = camera_ops.unproject(cam_kind, cam_params, pix_b)

    # --- essential RANSAC over the pair's own bearing matches
    E, _, ess_inl = essential_ransac_core(sample_ess(good), b1, b2, good)
    ess_inl = ess_inl & good & real_good

    # --- pose recovery + triangulation from the matches (cheirality vote)
    R21, t21, pts_c1, tri_ok = recover_pose_from_E(E, b1, b2, ess_inl)
    tri_ok = torch.where((torch.sum(tri_ok, dim=-1) >= 3)[:, None], tri_ok,
                         torch.ones_like(tri_ok))
    pts_c1 = torch.where(tri_ok[..., None], pts_c1,
                         torch.tensor([0.0, 0.0, 5.0], dtype=dt, device=dev))
    pts_c2 = pts_c1 @ R21.transpose(-1, -2) + t21[:, None, :]

    # --- Sim3 RANSAC between the two camera-frame point sets (the
    # loop-closure solver running on this step's own geometry)
    repro1, vis1 = camera_ops.project(cam_kind, cam_params, pts_c1)
    repro2, vis2 = camera_ops.project(cam_kind, cam_params, pts_c2)
    chi = torch.full((B, N), 9.21034, dtype=dt, device=dev)
    s_count = sim3_ransac_core(
        sample_sim3(tri_ok), pts_c1, pts_c2, tri_ok, repro1, repro2, vis1,
        vis2, chi, chi, cam_kind, cam_params, cam_kind, cam_params, "SIM3",
        False)[0]

    # --- bundle adjust each pair with the production LM solver: pose 0
    # fixed at identity, pose 1 seeded from the recovered relative pose,
    # landmarks from the step's own triangulation, measurements = normalized
    # pixels
    M = ba_capacity
    # valid points first, stable (the reference's argsort)
    order = torch.argsort((~tri_ok).to(torch.int32), dim=-1, stable=True)
    sel = order[:, :M]
    pts0 = torch.take_along_dim(pts_c1, sel[..., None], dim=-2)
    pt_ok = torch.take_along_dim(tri_ok, sel, dim=-1)
    eye4 = torch.eye(4, dtype=dt, device=dev).expand(B, 4, 4)
    pose2 = eye4.clone()
    pose2[:, :3, :3] = R21
    pose2[:, :3, 3] = t21
    bs1 = torch.take_along_dim(b1, sel[..., None], dim=-2)
    bs2 = torch.take_along_dim(b2, sel[..., None], dim=-2)
    meas1 = bs1[..., :2] / torch.clamp(bs1[..., 2:3], min=1e-6)
    meas2 = bs2[..., :2] / torch.clamp(bs2[..., 2:3], min=1e-6)
    i64 = dict(dtype=torch.int64, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    problem = ba.BAProblem(
        poses=torch.stack([eye4, pose2], dim=1),
        pose_fixed=torch.tensor([True, False], **b8).expand(B, 2),
        points=pts0,
        points_fixed=~pt_ok,
        obs_kf=torch.cat([torch.zeros(M, **i64), torch.ones(M, **i64)])
        .expand(B, 2 * M),
        obs_mp=torch.arange(M, **i64).repeat(2).expand(B, 2 * M),
        obs_meas=torch.cat([meas1, meas2], dim=1),
        obs_sqrt_info=torch.full((B, 2 * M), 100.0, dtype=dt, device=dev),
        obs_valid=torch.cat([pt_ok, pt_ok], dim=1),
        pe_a=torch.zeros(B, 1, **i64), pe_b=torch.ones(B, 1, **i64),
        pe_meas=pose2[:, None],          # relative to pose 1 = identity
        pe_sqrt_info=(torch.eye(6, dtype=dt, device=dev) * 0.1)
        .expand(B, 1, 6, 6),
        pe_valid=torch.ones(B, 1, **b8),
        pr_idx=torch.zeros(B, 1, **i64),
        pr_meas=eye4[:, None],
        pr_sqrt_info=torch.zeros(B, 1, 6, 6, dtype=dt, device=dev),
        pr_valid=torch.zeros(B, 1, **b8))
    res = ba.lm_run(problem, iterations=ba_iterations, cg_iters=0,
                    huber_delta=float(np.sqrt(5.991)), init_lambda=1e-4)
    ess_count = torch.sum(ess_inl, dim=-1, dtype=torch.int32)
    return ess_count, s_count.to(torch.int32), res.poses, res.points, res.cost


def make_sampler(hypotheses: int, seed: int = 0) -> Sampler:
    """Hypothesis banks for both RANSAC stages from seeded generators on the
    shard's device: one draw per shard and stage, seeded by ``seed``, the
    shard's first pair and the stage."""
    def sample(valid: torch.Tensor, size: int, pairs: np.ndarray):
        return sample_hypotheses(valid, hypotheses,
                                 (seed * 1_000_003 + int(pairs[0])) * 2
                                 + (size == 8), size)
    return sample


def build_update_step(mesh, width: int, height: int,
                      max_keypoints: int = 64, hypotheses: int = 16,
                      ba_capacity: int = 32, ba_iterations: int = 3,
                      camera=None):
    """The update step for one geometry over ``mesh``
    (``parallel/mesh.make_mesh``; its first axis is the data axis).

    Returns ``step(images, sampler=None) -> MultichipStep`` for (B, H, W)
    images (a host array or tensor; B divisible by the data axis); the
    outputs are concatenated on the first shard's device. ``sampler``
    draws both hypothesis banks (default ``make_sampler(hypotheses)``)."""
    from slam_tpu_torch.parallel.mesh import batch_sharding
    from slam_tpu_torch.params import Parameters, ParametersSlam

    settings = StaticSettings(Parameters(slam=ParametersSlam(
        maxKeypoints=max_keypoints)))
    p = settings.parameters.slam
    scale_factors = tuple(float(s) for s in settings.scaleFactors)
    sizes = level_sizes(width, height, scale_factors)
    # no BoW words in the pair step: nobody reads them
    spec = FrontendSpec(scale_factors,
                        tuple(settings.maxNumberOfKeypointsPerLevel()),
                        tuple(min_distances(settings, sizes)),
                        int(p.orbLkTrackLevel),
                        p.slamFeatureDetector.lower() == "fast", width, height)
    if camera is None:
        from slam_tpu_torch.geometry.camera import PinholeCamera
        camera = PinholeCamera(fx=0.8 * width, fy=0.8 * width,
                               cx=width / 2.0, cy=height / 2.0,
                               width=width, height=height)
    cam_kind, cam_params_np = camera_ops.pack_camera(camera)
    devices = batch_sharding(mesh, mesh.axis_names[0]).devices
    cam_params = {d: torch.from_numpy(cam_params_np).to(d)
                  for d in set(devices)}

    def step(images, sampler: Optional[Sampler] = None) -> MultichipStep:
        pin_full_f32()
        sampler = sampler or make_sampler(hypotheses)
        images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(
            images) else images)
        B, n = images.shape[0], len(devices)
        assert B % n == 0, f"batch {B} not divisible by the data axis {n}"
        b = B // n
        # front-end per shard, all enqueued before any is read
        feats = []
        for i, dev in enumerate(devices):
            img = images[i * b:(i + 1) * b].to(dev, torch.float32)
            txy = torch.zeros(b, N_TRACKED, 2, dtype=torch.float32, device=dev)
            tvalid = torch.zeros(b, N_TRACKED, dtype=torch.bool, device=dev)
            f = extract(img, txy, tvalid, spec)
            feats.append((f.pts, f.valid, f.desc))
        outs = []
        for i, dev in enumerate(devices):
            # frame b pairs with frame (b + 1) mod B: the next shard's first
            # row crosses devices
            head = tuple(t[:1].to(dev) for t in feats[(i + 1) % n])
            nxt = tuple(torch.cat([t[1:], h]) for t, h in zip(feats[i], head))
            pairs = np.arange(i * b, (i + 1) * b)
            outs.append(pair_chain(
                feats[i], nxt, lambda v: sampler(v, 8, pairs),
                lambda v: sampler(v, 3, pairs), cam_kind, cam_params[dev],
                ba_capacity, ba_iterations))
        cat = lambda ts: torch.cat([t.to(devices[0]) for t in ts])
        ess, s3, poses, points, cost = (cat(ts) for ts in zip(*outs))
        return MultichipStep(keypoints=cat([f[0] for f in feats]),
                             descriptors=cat([f[2] for f in feats]),
                             essential_inliers=ess, sim3_inliers=s3,
                             poses=poses, points=points, ba_cost=cost)

    return step
