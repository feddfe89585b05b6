"""Device-SLAM: the device-resident backend plus the host loop-closure
consumer, the serving path's full SLAM loop (port of
slam_tpu/pipeline/device_slam.py).

``BatchedDeviceVO`` runs VO, the sliding-window local BA and in-scan
loop-candidate retrieval on the device. This module consumes the per-frame
``(loop_frame, loop_score)`` flags and the closure snapshot ring
(camera-frame landmark points, descriptors, observations and poses stored
at the retrieval cadence) and runs the reference's geometric closure stack
on flagged pairs, on the host in NumPy:

    descriptor matching (mutual-NN + Lowe ratio; matchForLoopClosures
    semantics, keyframe_matcher.cpp:50-158, without the BoW buckets and
    orientation vote the snapshot ring does not carry)
 -> Sim3 RANSAC over camera-frame point pairs (loop_ransac.cpp:47-110,
    ``ops/ransac.sim3_ransac_host``, per-octave levelSigmaSq chi2 gates)
 -> Sim3 refinement (optimize_transform.cpp:63-155,
    ``ops/sim3_opt.optimize_sim3_transform_host``)
 -> acceptance gates (loop_closer.cpp:280-338: unnecessary-correction and
    drift-rate gates over time and distance traveled)
 -> correction (loop_closer.cpp:380-561, T = poseCW^-1 o candToCurr o
    candidatePoseCW with the Sim3 scale discarded): the logged trajectory
    gets the rigid and time-interpolated smear, and the device state is
    rebased, duplicate-landmark merge included, in one run of batched ops
    (``device_vo._rebase_states``).

Chunks stay asynchronous: ``advance`` enqueues chunk n+1 on the device and
then consumes chunk n, so corrections land one chunk late; the lag of each
accepted closure is recorded in ``closure_lags``. A chunk's poses, flags and
snapshot rows are copied to pinned host buffers right behind its work, and
the consumer waits only on that copy's event: a plain device-to-host copy
at consume time would also wait for chunk n+1, queued behind it on the same
stream.
"""
from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.ops.hamming import (HAMMING_DIST_THR_LOW,
                                        hamming_matrix_host)
from slam_tpu_torch.ops.ransac import sim3_ransac_host
from slam_tpu_torch.ops.sim3_opt import optimize_sim3_transform_host
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.ops.stamp import durations
from slam_tpu_torch.pipeline.device_vo import (BatchedDeviceVO, DeviceVOConfig,
                                               SnapOut, VOStepOut,
                                               _rebase_states, _resolve_camera,
                                               _resolve_settings,
                                               loop_candidates, stamp_stages)
from slam_tpu_torch.pipeline.loop_closer import drift_gate_angle
from slam_tpu_torch.utils import timer
from slam_tpu_torch.utils.timer import section, timed_as


class DeviceSlamParams(NamedTuple):
    """Host closure-stack knobs; defaults mirror `params.ParametersSlam`."""
    frame_dt: float = 0.05            # seconds per frame (camera rate)
    lowe_ratio: float = 0.9           # loopClosureFeatureMatchLoweRatio
    min_feature_matches: int = 20     # minLoopClosureFeatureMatches
    ransac_iterations: int = 200      # loopClosureRansacIterations
    ransac_min_inliers: int = 20      # loopClosureRansacMinInliers
    fix_scale: bool = True            # loopClosureRansacFixScale
    inlier_threshold: float = 10.0    # loopClosureInlierThreshold
    min_closure_gap_s: float = 5.0    # correction >= 5 s gate,
    #                                   loop_closer.cpp:166-169
    # host-side retrieval score gate (the device's cfg.loop_min_score may
    # stay 0 = report everything). None = calibrate from the bootstrap
    # segment: the first `calib_frames` frames are assumed revisit-free, and
    # the gate is their best eligible score + `calib_margin`, clamped to
    # [calib_floor, 0.995] (the bowScoreRatio analogue of
    # bow_index.cpp:95-176)
    min_loop_score: Optional[float] = None
    calib_frames: int = 60
    calib_margin: float = 0.02
    calib_floor: float = 0.5
    max_drift_m_per_s: float = 0.05   # maximumDriftMetersPerSecond
    max_drift_m_per_m: float = 0.05   # maximumDriftMetersPerTraveled
    max_drift_rad_per_s: float = 0.01  # maximumDriftRadiansPerSecond
    max_drift_rad_per_m: float = 0.01  # maximumDriftRadiansPerTraveled
    apply_closures: bool = True       # applyLoopClosures
    # post-closure map hygiene (searchAndDeduplicate + map-point merge,
    # loop_closer.cpp:531-591) inside the rebase, with a metric merge radius
    # in place of the reference's pixel search radius
    merge_landmarks: bool = True
    merge_radius_m: float = 0.3


def calibrate_loop_gate(bootstrap_scores: np.ndarray, margin: float = 0.02,
                        floor: float = 0.5, ceil: float = 0.995) -> float:
    """Retrieval-score gate from a revisit-free bootstrap segment.

    ``bootstrap_scores``: per-frame best-eligible-candidate scores
    (``VOStepOut.loop_score``; entries <= -0.5 mean no eligible candidate
    and are ignored). The gate sits ``margin`` above the largest observed
    false-positive score."""
    s = np.asarray(bootstrap_scores, np.float64).ravel()
    s = s[s > -0.5]
    base = float(s.max()) if len(s) else floor
    return float(np.clip(base + margin, floor, ceil))


class ClosureEvent(NamedTuple):
    seq: int
    query_frame: int
    cand_frame: int
    score: float
    n_matches: int
    n_inliers: int
    accepted: bool
    reason: str                        # LoopCloserStats-style outcome tag
    T: Optional[np.ndarray]            # (4, 4) world correction when accepted


def _mutual_nn_lowe(dist: np.ndarray, valid1: np.ndarray,
                    valid2: np.ndarray, lowe_ratio: float):
    """Mutual-nearest matching with Lowe second-best ratio and THR_LOW
    acceptance over a host Hamming matrix. Returns (idx1, idx2) pairs."""
    d = dist.astype(np.int64).copy()
    BIG = 10_000
    d[~valid1, :] = BIG
    d[:, ~valid2] = BIG
    if d.shape[1] < 2:
        return np.zeros(0, int), np.zeros(0, int)
    best2 = np.argmin(d, axis=1)
    part = np.partition(d, 1, axis=1)
    best_d, second_d = part[:, 0], part[:, 1]
    best1_of_2 = np.argmin(d, axis=0)
    i1 = np.arange(d.shape[0])
    ok = (valid1
          & (best_d <= HAMMING_DIST_THR_LOW)
          & (best_d <= lowe_ratio * second_d)
          & (best1_of_2[best2] == i1))
    return i1[ok], best2[ok]


def _to_host(tensors):
    """Copies of ``tensors`` on the host, and the CUDA event after which
    they hold their values (None on the CPU, where they already do)."""
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for b, t in zip(bufs, tensors):
        b.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return bufs, event


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, enqueued without waiting for the work
    already queued on the device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class DeviceSlam:
    """S concurrent device-resident SLAM sessions with host loop closure.

    ``cfg``: a DeviceVOConfig with ``loop_every > 0`` (and usually
    ``window > 0`` for the in-scan local BA); ``batch``: the number of
    sequences S. The state lives on ``device``; tests pass ``"cpu"``."""

    def __init__(self, cfg: DeviceVOConfig, batch: int, camera=None,
                 settings: Optional[StaticSettings] = None,
                 params: DeviceSlamParams = DeviceSlamParams(),
                 device="cuda"):
        assert cfg.loop_every > 0, (
            "DeviceSlam needs in-scan loop-candidate retrieval "
            "(cfg.loop_every > 0)")
        self.cfg = cfg
        self.batch = batch
        self.params = params
        self.camera = _resolve_camera(cfg, camera)
        self.vo = BatchedDeviceVO(cfg, batch=batch, camera=self.camera,
                                  settings=settings, device=device)
        # per-observation chi2/weight scaling for the closure stack
        # (levelSigmaSq, loop_ransac.cpp:28-40) from the snapshot octaves
        self._level_sigma_sq = np.asarray(
            _resolve_settings(cfg, settings).levelSigmaSq, np.float64)
        self._pose_log: List[List[np.ndarray]] = [[] for _ in range(batch)]
        self._last_closure = [-(10 ** 9)] * batch
        self.closures: List[ClosureEvent] = []
        self.closure_lags: List[int] = []   # frames between flagged query
        #                                     and applied rebase
        self._pending: deque = deque()
        self._frames_done = 0
        self._calib_scores: List[List[float]] = [[] for _ in range(batch)]
        self._score_gate: List[Optional[float]] = [
            params.min_loop_score] * batch
        # host mirror of the device snapshot ring, filled from each chunk's
        # SnapOut rows; descriptors as uint32 like the reference's
        S, R, P = batch, cfg.loop_slots, cfg.loop_points
        self._ring_frame = np.full((S, R), -1, np.int64)
        self._ring_pc = np.zeros((S, R, P, 3), np.float32)
        self._ring_desc = np.zeros((S, R, P, 8), np.uint32)
        self._ring_obs = np.zeros((S, R, P, 2), np.float32)
        self._ring_pvalid = np.zeros((S, R, P), bool)
        self._ring_pose = np.broadcast_to(
            np.eye(4, dtype=np.float32), (S, R, 4, 4)).copy()
        self._ring_octave = np.zeros((S, R, P), np.int32)

    # ------------------------------------------------------------------

    @timed_as("slam.advance")
    def advance(self, images: np.ndarray, odom_deltas: np.ndarray):
        """Enqueue one (S, T, ...) chunk; then consume the PREVIOUS chunk's
        loop flags while this one runs on the device (one-chunk lag).
        While timing is on, the chunk's stage stamps travel with its
        outputs and the consumer adds them to the timer as device time
        (``vo.device.<stage>``, ``device_vo.stamp_stages``)."""
        out = self.vo.advance(images, odom_deltas)
        with section("slam.to_host"):
            stamps = (() if timer.TIME_STATS is None
                      else (self.vo.last_stamps,))
            host = _to_host((out.pose_cw, out.loop_frame, out.loop_score)
                            + tuple(self.vo.last_snaps) + stamps)
        # fourth slot: per-sequence corrections accepted AFTER this chunk
        # was enqueued but BEFORE it is consumed; its poses were computed
        # from pre-rebase state and are corrected on arrival
        self._pending.append([host, self._frames_done, {}])
        self._frames_done += images.shape[1]
        while len(self._pending) > 1:
            self._consume(*self._pending.popleft())
        return out

    def finish(self) -> None:
        """Drain pending chunks."""
        while self._pending:
            self._consume(*self._pending.popleft())

    def trajectory(self, seq: int) -> np.ndarray:
        """(F, 4, 4) loop-corrected pose_cw log of one sequence."""
        return np.stack(self._pose_log[seq]) if self._pose_log[seq] else \
            np.zeros((0, 4, 4), np.float32)

    # ------------------------------------------------------------------

    @timed_as("slam.consume")
    def _consume(self, host, offset: int, late_corr: dict) -> None:
        bufs, event = host
        if event is not None:
            with section("slam.consume_wait"):
                event.synchronize()
        pose_t, frame_t, score_t = bufs[:3]
        n_snap = len(SnapOut._fields)
        snaps = SnapOut(*(t.numpy() for t in bufs[3:3 + n_snap]))
        if len(bufs) > 3 + n_snap:
            for stage, s in durations(bufs[-1].numpy(), stamp_stages(
                    self.cfg, pose_t.shape[1])).items():
                timer.add_device(f"vo.device.{stage}", s)
        with section("slam.mirror"):
            poses = pose_t.numpy().copy()                    # (S, T, 4, 4)
            for s in range(self.batch):
                Tc = late_corr.get(s)
                if Tc is not None:
                    self._pose_log[s].extend(p @ Tc for p in poses[s])
                else:
                    self._pose_log[s].extend(poses[s])
            self._mirror_snaps(snaps, late_corr)
        with section("slam.gates"):
            best = self._candidates(score_t, frame_t, pose_t, offset)
        if best:
            self._close(best)

    def _candidates(self, score_t, frame_t, pose_t, offset: int) -> dict:
        """Finish the score gate's calibration on the bootstrap segment;
        the best flagged query a sequence that passes the gates, as {seq:
        (query, candidate, score)}."""
        # score-gate calibration from the bootstrap segment (assumed
        # revisit-free), finalized once the segment is past
        p = self.params
        if p.min_loop_score is None:
            scores = score_t.numpy()                         # (S, T)
            T = scores.shape[1]
            for s in range(self.batch):
                if self._score_gate[s] is not None:
                    continue
                hi = min(p.calib_frames - offset, T)
                if hi > 0:
                    self._calib_scores[s].extend(scores[s, :hi].tolist())
                if offset + T >= p.calib_frames:
                    self._score_gate[s] = calibrate_loop_gate(
                        np.asarray(self._calib_scores[s]),
                        p.calib_margin, p.calib_floor)

        rows = loop_candidates(VOStepOut(pose_t, None, None, frame_t, score_t),
                               frame_offset=offset)
        if len(rows) == 0:
            return {}
        gap_frames = p.min_closure_gap_s / p.frame_dt
        best = {}
        for seq_f, q_f, c_f, score in rows:
            seq, q, c = int(seq_f), int(q_f), int(c_f)
            # only snapshot-stored queries carry closure geometry
            if q % self.cfg.loop_every != 0:
                continue
            if q - self._last_closure[seq] < gap_frames:
                continue
            gate = self._score_gate[seq]
            if gate is None or score < gate:
                continue
            cur = best.get(seq)
            if cur is None or score > cur[2]:
                best[seq] = (q, c, float(score))
        return best

    def _close(self, best: dict) -> None:
        """Try each sequence's candidate; rebase the device state of the
        sequences whose closure is accepted."""
        Ts = np.tile(np.eye(4, dtype=np.float32), (self.batch, 1, 1))
        apply = np.zeros(self.batch, bool)
        cands = np.full(self.batch, -1, np.int32)
        R = self.cfg.loop_slots
        cand_slots = np.zeros(self.batch, np.int64)
        slot_T = np.tile(np.eye(4, dtype=np.float32), (self.batch, R, 1, 1))
        slot_frame = np.full((self.batch, R), -2, np.int32)
        for seq, (q, c, score) in best.items():
            with section("slam.try_close"):
                ev = self._try_close(seq, q, c, score)
            self.closures.append(ev)
            if ev.accepted and self.params.apply_closures:
                Ts[seq] = ev.T
                apply[seq] = True
                cands[seq] = c
                cand_slots[seq] = (c // self.cfg.loop_every) % R
                self._slot_corrections(seq, c, q, ev.T, slot_T, slot_frame)
                self._correct_log(seq, c, q, ev.T)
                self._last_closure[seq] = q
                self.closure_lags.append(self._frames_done - q)
        if apply.any():
            dev = self.vo.device
            with section("slam.rebase"):
                self.vo.state = _rebase_states(
                    self.vo.state, _to_device(Ts, dev),
                    _to_device(apply, dev), _to_device(cands, dev),
                    _to_device(cand_slots, dev), _to_device(slot_T, dev),
                    _to_device(slot_frame, dev),
                    merge_radius=float(self.params.merge_radius_m),
                    merge=bool(self.params.merge_landmarks))
            # chunks still in flight were computed from pre-rebase state:
            # their poses get the same right-multiplied correction when
            # they arrive (reference analogue: frames queued behind the
            # backend during correctLoop replay onto the corrected map,
            # mapper.cpp:328-343 fastForward)
            for entry in self._pending:
                for s in np.nonzero(apply)[0]:
                    prev = entry[2].get(int(s), np.eye(4, dtype=np.float32))
                    entry[2][int(s)] = prev @ Ts[s]

    # ------------------------------------------------------------------

    def _mirror_snaps(self, snaps: SnapOut, late_corr: dict) -> None:
        """Fold one chunk's SnapOut rows into the host ring mirror. Rows of
        a chunk that was in flight when a rebase landed were computed from
        pre-rebase state: their poses get the pending correction (their
        frames are all past the closure query, so the full rigid ``T``);
        camera-frame points are invariant."""
        desc = snaps.desc.view(np.uint32)                 # int32 bit views
        for s in range(self.batch):
            Tc = late_corr.get(s)
            sl = snaps.slot[s]
            self._ring_frame[s, sl] = snaps.frame[s]
            self._ring_pc[s, sl] = snaps.pc[s]
            self._ring_desc[s, sl] = desc[s]
            self._ring_obs[s, sl] = snaps.obs[s]
            self._ring_pvalid[s, sl] = snaps.pvalid[s]
            self._ring_pose[s, sl] = (snaps.pose[s] if Tc is None
                                      else snaps.pose[s] @ Tc)
            self._ring_octave[s, sl] = snaps.octave[s]

    def _slot_corrections(self, seq: int, c: int, q: int, T: np.ndarray,
                          slot_T: np.ndarray, slot_frame: np.ndarray) -> None:
        """Per-ring-slot correction matrices matching `_correct_log`'s
        time-interpolated smear (loop_closer.cpp:421-470), filled for every
        slot the mirror knows and applied to the mirror poses; the device
        rebase applies the same matrices to its sig_pose rows (falling back
        to the rigid predicate for rows overwritten in flight)."""
        start = max(c, self._last_closure[seq] + 1, 0)
        T1 = se3.Sim3.from_se3(np.asarray(T, np.float64))
        T0 = se3.Sim3.identity()
        for r in range(self.cfg.loop_slots):
            f = int(self._ring_frame[seq, r])
            if f < 0:
                continue
            if f >= q:
                Tl = np.asarray(T, np.float64)
            elif f <= start:
                Tl = np.eye(4)
            else:
                lam = (f - start) / max(q - start, 1)
                Tl = se3.interpolate_sim3(
                    T0, T1, min(max(lam, 0.0), 1.0)).to_se3()
            slot_T[seq, r] = Tl.astype(np.float32)
            slot_frame[seq, r] = f
            self._ring_pose[seq, r] = (
                self._ring_pose[seq, r].astype(np.float64) @ Tl
            ).astype(np.float32)

    def _snapshots(self, seq: int, frame_q: int, frame_c: int):
        """Both closure snapshots, read from the host ring mirror."""
        rows = []
        for frame in (frame_q, frame_c):
            slot = (frame // self.cfg.loop_every) % self.cfg.loop_slots
            rows.append((self._ring_frame[seq, slot],
                         self._ring_pc[seq, slot],
                         self._ring_desc[seq, slot],
                         self._ring_obs[seq, slot],
                         self._ring_pvalid[seq, slot],
                         self._ring_pose[seq, slot],
                         self._ring_octave[seq, slot]))
        return rows[0], rows[1]

    def _try_close(self, seq: int, q: int, c: int,
                   score: float) -> ClosureEvent:
        p = self.params

        def rej(reason, n_matches=0, n_inliers=0):
            return ClosureEvent(seq, q, c, score, n_matches, n_inliers,
                                False, reason, None)

        ((fq, pc_q, desc_q, obs_q, val_q, pose_q, oct_q),
         (fc, pc_c, desc_c, obs_c, val_c, pose_c, oct_c)) = \
            self._snapshots(seq, q, c)
        if int(fq) != q or int(fc) != c:
            return rej("ring_overwritten")

        with section("slam.match"):
            dist = hamming_matrix_host(desc_q, desc_c)
            i_q, i_c = _mutual_nn_lowe(dist, val_q, val_c, p.lowe_ratio)
        if len(i_q) < p.min_feature_matches:
            return rej("too_few_feature_matches", n_matches=len(i_q))

        # Sim3 RANSAC over camera-frame point pairs: "1" = query/current,
        # "2" = candidate, so the recovered transform12 is candToCurr (loop
        # RANSAC ctor loop_ransac.cpp:8-45); chi2 gates and refinement
        # weights scale with the keypoints' levelSigmaSq
        lv = self._level_sigma_sq
        sig_q = lv[np.clip(oct_q[i_q], 0, len(lv) - 1)]
        sig_c = lv[np.clip(oct_c[i_c], 0, len(lv) - 1)]
        res = sim3_ransac_host(self.camera, self.camera,
                               pc_q[i_q], pc_c[i_c], sig_q, sig_c,
                               p.ransac_iterations, dof="SIM3",
                               fix_scale=p.fix_scale,
                               min_inliers=p.ransac_min_inliers)
        if not res.ok:
            return rej("ransac_failed", n_matches=len(i_q))

        inl = res.inliers
        R12, t12, s12 = optimize_sim3_transform_host(
            res.rot_12, res.trans_12, res.scale_12,
            pc_q[i_q][inl], pc_c[i_c][inl],
            obs_q[i_q][inl], obs_c[i_c][inl],
            sig_q[inl], sig_c[inl],
            p.inlier_threshold, p.fix_scale)
        cand_to_curr = se3.Sim3(R12, t12, s12)

        # acceptance gates (loop_closer.cpp:280-338)
        updated_pose = (cand_to_curr * se3.Sim3.from_se3(pose_c)).to_se3()
        correction_distance = float(np.linalg.norm(
            se3.camera_center(pose_q) - se3.camera_center(updated_pose)))
        distance_from_candidate = float(np.linalg.norm(
            se3.camera_center(pose_c) - se3.camera_center(updated_pose)))
        if distance_from_candidate > 1.0 * correction_distance:
            return rej("unnecessary", len(i_q), res.num_inliers)
        angle_change = drift_gate_angle(cand_to_curr.to_se3(), pose_c,
                                        pose_q)
        time_between = max((q - c) * p.frame_dt, 1e-9)
        log = self._pose_log[seq]
        centers = np.stack([se3.camera_center(log[f])
                            for f in range(c, min(q + 1, len(log)))])
        traveled = float(np.sum(np.linalg.norm(np.diff(centers, axis=0),
                                               axis=1))) if len(centers) > 1 \
            else 1e-9
        if (correction_distance / time_between > p.max_drift_m_per_s
                or correction_distance / max(traveled, 1e-9)
                > p.max_drift_m_per_m):
            return rej("too_large_position_drift", len(i_q), res.num_inliers)
        if (angle_change / time_between > p.max_drift_rad_per_s
                or angle_change / max(traveled, 1e-9) > p.max_drift_rad_per_m):
            return rej("too_large_angle_drift", len(i_q), res.num_inliers)

        # correction transform (loop_closer.cpp:405; scale discarded by
        # sim3ToSe3 as the interactive correct_loop does)
        T = (se3.Sim3.from_se3(pose_q).inverse() * cand_to_curr
             * se3.Sim3.from_se3(pose_c)).to_se3().astype(np.float32)
        return ClosureEvent(seq, q, c, score, len(i_q), res.num_inliers,
                            True, "ok", T)

    def _correct_log(self, seq: int, c: int, q: int, T: np.ndarray) -> None:
        """Rigid + time-interpolated smear of the correction over the logged
        trajectory (loop_closer.cpp:421-470): frames at/after the query move
        rigidly by ``T``; frames between the correction start (candidate or
        previous closure, whichever is newer) and the query interpolate
        between identity and ``T``."""
        log = self._pose_log[seq]
        start = max(c, self._last_closure[seq] + 1, 0)
        T1 = se3.Sim3.from_se3(T.astype(np.float64))
        T0 = se3.Sim3.identity()
        for f in range(start, len(log)):
            if f >= q:
                Tl = T1
            else:
                lam = (f - start) / max(q - start, 1)
                Tl = se3.interpolate_sim3(T0, T1, min(max(lam, 0.0), 1.0))
            log[f] = (se3.Sim3.from_se3(log[f].astype(np.float64))
                      * Tl).to_se3().astype(np.float32)
