"""Loop closure pipeline.

Rebuild of the reference loop closer (reference: loop_closer.cpp; port of
slam_tpu/pipeline/loop_closer.py):
BoW-equivalent retrieval -> fast time/distance rejections -> feature matching
-> Sim3 RANSAC (batched on the device, `ops/ransac.py`) -> Sim3-guided match
expansion -> transform refinement (device LM, `ops/sim3_opt.py`) ->
drift-rate acceptance gates ->
``correct_loop`` with time-interpolated Sim3 smearing of intermediate
keyframes, map-point re-expression, global retriangulation, merging and
deduplication (loop_closer.cpp:380-561).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.ids import KfId, KpId, MpId, CURRENT_MAP_ID
from slam_tpu_torch.map.keyframe import Keyframe
from slam_tpu_torch.map.map_point import MapPointStatus
from slam_tpu_torch.map.mapdb import Atlas, LoopClosureEdge, LoopStage, MapDB, MapKf
from slam_tpu_torch.ops.ransac import Sim3Ransac
from slam_tpu_torch.ops.sim3_opt import optimize_sim3_transform
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.pipeline import matcher
from slam_tpu_torch.pipeline.bundle_adjustment import never_triangulated
from slam_tpu_torch.pipeline.mapper_helpers import triangulate_map_points
from slam_tpu_torch.pipeline.relocation import try_relocation
from slam_tpu_torch.utils.stats import Loop, LoopCloserStats


@dataclasses.dataclass
class LoopClosure:
    """reference: loop_closer.cpp:31-40"""
    candidate_kf_id: KfId
    cand_to_curr: se3.Sim3
    keypoint_matches: List[Tuple[KpId, KpId]]
    map_point_matches: List[Tuple[MpId, MpId]]


def _next_valid_kf_id(kf_id: KfId, map_db: MapDB) -> KfId:
    """reference: loop_closer.cpp:81-89"""
    max_kf_id = max(map_db.keyframes)
    while kf_id <= max_kf_id:
        if kf_id in map_db.keyframes:
            return kf_id
        kf_id = KfId(int(kf_id) + 1)
    return KfId(-1)


def reexpress_map_points(map_db: MapDB, local_map_points: Dict[MpId, KfId],
                         prev_poses: Dict[KfId, np.ndarray],
                         settings: StaticSettings) -> None:
    """Move each map point with its reference keyframe's correction, from
    ``prev_poses`` to the keyframe's corrected pose (loop_closer.cpp:
    492-506). A track's point that was never triangulated has no position
    to move: it stays at the origin, where the global BA leaves it out.
    The JAX package moves it too, to the correction's translation, and its
    global BA then takes it in."""
    for mp_id, ref_kf in local_map_points.items():
        mp = map_db.map_points.get(mp_id)
        if mp is None or never_triangulated(mp):
            continue
        corrected_cw = se3.Sim3.from_se3(map_db.keyframes[ref_kf].pose_cw)
        previous_cw = se3.Sim3.from_se3(prev_poses[ref_kf])
        mp.position = (corrected_cw.inverse() * previous_cw).map(mp.position)
        mp.update_descriptor(map_db)
        mp.update_distance_and_norm(map_db, settings)


class LoopCloser:
    """reference: loop_closer.cpp:93-640 (LoopCloserImplementation). Its
    RANSAC and Sim3 refinement run on ``device``."""

    def __init__(self, settings: StaticSettings, bow_index, map_db: MapDB,
                 atlas: Optional[Atlas] = None, device="cuda"):
        self.settings = settings
        self.device = torch.device(device)
        self.bow_index = bow_index
        self.map_db = map_db
        self.atlas = atlas if atlas is not None else []
        self.stats = LoopCloserStats(settings.parameters.slam.printLoopCloserStats)
        self.prev_loop_closure_kf_id = KfId(-1)
        self.previous_closure_t = -1.0
        self.ransac_seed = 94235682
        # step-mode hooks, set via Mapper.connect_debug_api (reference:
        # LoopCloserImplementation's dataPublisher/commands members)
        self.data_publisher = None
        self.commands = None

    def _step_wait(self, message: str) -> None:
        from slam_tpu_torch.utils.commands import step_wait
        step_wait(self.commands, self.data_publisher, self.map_db, None,
                  self.settings.parameters.slam, message)

    # ------------------------------------------------------------------

    def try_loop_closure(self, current_kf: Keyframe,
                         adjacent: List[KfId]) -> bool:
        """reference: loop_closer.cpp:126-378"""
        parameters = self.settings.parameters.slam
        map_db = self.map_db
        candidates = self.bow_index.get_bow_similar(map_db, self.atlas, current_kf)

        heavy_computations = 0
        map_db.loop_stages.clear()
        loop_closure_candidates: List[LoopClosure] = []

        for candidate in candidates:
            map_db.loop_stages[candidate.map_kf] = LoopStage.BOW_MATCH
            if candidate.map_kf.map_id != CURRENT_MAP_ID:
                try_relocation(current_kf.id, candidate.map_kf, map_db,
                               self.atlas, parameters, self.settings,
                               device=self.device)
                continue
            kf_id = candidate.map_kf.kf_id
            if heavy_computations > 10:
                break
            self.stats.new_loop()
            candidate_kf = map_db.keyframes[kf_id]

            # fast rejections (loop_closer.cpp:164-187)
            correction_length = current_kf.t - max(candidate_kf.t,
                                                   self.previous_closure_t)
            if correction_length < 5.0:
                self.stats.update(Loop.TOO_CLOSE_TIME)
                continue
            if (current_kf.t - candidate_kf.t) < 2.15:
                self.stats.update(Loop.TOO_CLOSE_TIME)
                continue
            is_adjacent = kf_id in adjacent
            kf_distance = float(np.linalg.norm(candidate_kf.camera_center()
                                               - current_kf.camera_center()))
            unnecessarily_close_distance = 0.75
            unnecessarily_close_distance_kf = 0.5
            if is_adjacent and kf_distance < unnecessarily_close_distance_kf:
                self.stats.update(Loop.UNNECESSARY_EARLY)
                continue

            heavy_computations += 1
            map_db.loop_stages[candidate.map_kf] = LoopStage.QUICK_TESTS

            matched_feature_ids = matcher.match_for_loop_closures(
                current_kf, candidate_kf, map_db, map_db, parameters,
                device=self.device)
            matches: List[Tuple[MpId, MpId]] = []
            for i, kf_idx2 in enumerate(matched_feature_ids):
                if kf_idx2 >= 0:
                    mp1 = int(current_kf.map_points[i])
                    mp2 = int(candidate_kf.map_points[kf_idx2])
                    if mp1 >= 0 and mp2 >= 0 and mp1 != mp2:
                        matches.append((MpId(mp1), MpId(mp2)))
            if len(matches) < parameters.minLoopClosureFeatureMatches:
                self.stats.update(Loop.TOO_FEW_FEATURE_MATCHES)
                continue

            # Sim3 RANSAC (loop_closer.cpp:221-234)
            ransac = self._build_ransac(current_kf, candidate_kf, matches,
                                        map_db, map_db)
            res = ransac.solve(
                parameters.loopClosureRansacIterations, dof="SIM3",
                fix_scale=parameters.loopClosureRansacFixScale,
                min_inliers=parameters.loopClosureRansacMinInliers,
                seed=self.ransac_seed)
            if not res.ok:
                self.stats.update(Loop.RANSAC_FAILED)
                continue
            map_db.loop_stages[candidate.map_kf] = LoopStage.MAP_POINT_MATCHES

            ransac_inlier_matches = [m for m, ok in zip(matches, res.inliers) if ok]
            transform12 = np.eye(4)
            transform12[:3, :3] = res.scale_12 * res.rot_12
            transform12[:3, 3] = res.trans_12
            matcher.match_map_points_sim3(current_kf, candidate_kf, transform12,
                                          map_db, ransac_inlier_matches,
                                          self.settings)
            keypoint_matches = [
                (map_db.map_points[a].observations[current_kf.id],
                 map_db.map_points[b].observations[candidate_kf.id])
                for a, b in ransac_inlier_matches]

            # refine with all inliers (loop_closer.cpp:272-277)
            sim3 = self._refine_transform(current_kf, candidate_kf,
                                          ransac_inlier_matches,
                                          res.rot_12, res.trans_12, res.scale_12)

            updated_pose = (sim3 * se3.Sim3.from_se3(candidate_kf.pose_cw)).to_se3()

            # acceptance gates (loop_closer.cpp:280-338)
            correction_distance = float(np.linalg.norm(
                se3.camera_center(current_kf.pose_cw)
                - se3.camera_center(updated_pose)))
            if is_adjacent and correction_distance < unnecessarily_close_distance:
                self.stats.update(Loop.UNNECESSARY)
                continue
            distance_from_candidate = float(np.linalg.norm(
                se3.camera_center(candidate_kf.pose_cw)
                - se3.camera_center(updated_pose)))
            if distance_from_candidate > 1.0 * correction_distance:
                self.stats.update(Loop.UNNECESSARY)
                continue

            angle_change = drift_gate_angle(sim3.to_se3(),
                                            candidate_kf.pose_cw,
                                            current_kf.pose_cw)

            distance_traveled = 0.0
            curr = current_kf.id
            while curr != candidate_kf.id:
                kf1 = map_db.keyframes[curr]
                curr = kf1.previous_kf_id
                kf2 = map_db.keyframes[curr]
                distance_traveled += float(np.linalg.norm(
                    kf1.camera_center() - kf2.camera_center()))
            time_between = current_kf.t - candidate_kf.t
            if (correction_distance / time_between > parameters.maximumDriftMetersPerSecond
                    or correction_distance / max(distance_traveled, 1e-9)
                    > parameters.maximumDriftMetersPerTraveled):
                self.stats.update(Loop.TOO_LARGE_POSITION_DRIFT)
                continue
            if (angle_change / time_between > parameters.maximumDriftRadiansPerSecond
                    or angle_change / max(distance_traveled, 1e-9)
                    > parameters.maximumDriftRadiansPerTraveled):
                self.stats.update(Loop.TOO_LARGE_ANGLE_DRIFT)
                continue

            loop_closure_candidates.append(LoopClosure(
                candidate_kf_id=candidate_kf.id,
                cand_to_curr=sim3,
                keypoint_matches=keypoint_matches,
                map_point_matches=ransac_inlier_matches))
            map_db.loop_stages[candidate.map_kf] = LoopStage.ACCEPTED
            self.stats.update(Loop.OK)

        self.stats.finish_frame()
        if not parameters.applyLoopClosures:
            return False

        loop_closure_candidates.sort(key=lambda lc: -int(lc.candidate_kf_id))
        for loop_closure in loop_closure_candidates:
            self.correct_loop(current_kf, loop_closure)
            self.prev_loop_closure_kf_id = current_kf.id
            return True
        return False

    # ------------------------------------------------------------------

    def _build_ransac(self, kf1: Keyframe, kf2: Keyframe,
                      matches: List[Tuple[MpId, MpId]],
                      map_db1: MapDB, map_db2: MapDB) -> Sim3Ransac:
        """reference: loop_ransac.cpp:8-45 (LoopRansac constructor)"""
        pts1, pts2, sig1, sig2 = [], [], [], []
        for a, b in matches:
            mp1 = map_db1.map_points[a]
            mp2 = map_db2.map_points[b]
            pts1.append(kf1.pose_cw[:3, :3] @ mp1.position + kf1.pose_cw[:3, 3])
            pts2.append(kf2.pose_cw[:3, :3] @ mp2.position + kf2.pose_cw[:3, 3])
            o1 = int(kf1.shared.octave[int(mp1.observations[kf1.id])])
            o2 = int(kf2.shared.octave[int(mp2.observations[kf2.id])])
            sig1.append(float(self.settings.levelSigmaSq[o1]))
            sig2.append(float(self.settings.levelSigmaSq[o2]))
        return Sim3Ransac(kf1.shared.camera, kf2.shared.camera,
                          np.array(pts1), np.array(pts2),
                          np.array(sig1), np.array(sig2), device=self.device)

    def _refine_transform(self, kf1: Keyframe, kf2: Keyframe,
                          matches: List[Tuple[MpId, MpId]],
                          rot_12, trans_12, scale_12) -> se3.Sim3:
        """reference: optimize_transform.cpp via loop_closer.cpp:272-277"""
        map_db = self.map_db
        pts1, pts2, obs1, obs2, s1, s2 = [], [], [], [], [], []
        for a, b in matches:
            mp1 = map_db.map_points[a]
            mp2 = map_db.map_points[b]
            kp1 = int(mp1.observations[kf1.id])
            kp2 = int(mp2.observations[kf2.id])
            pts1.append(kf1.pose_cw[:3, :3] @ mp1.position + kf1.pose_cw[:3, 3])
            pts2.append(kf2.pose_cw[:3, :3] @ mp2.position + kf2.pose_cw[:3, 3])
            b1 = kf1.shared.bearings[kp1]
            b2 = kf2.shared.bearings[kp2]
            obs1.append(b1[:2] / b1[2])
            obs2.append(b2[:2] / b2[2])
            s1.append(float(self.settings.levelSigmaSq[int(kf1.shared.octave[kp1])]))
            s2.append(float(self.settings.levelSigmaSq[int(kf2.shared.octave[kp2])]))
        p = self.settings.parameters.slam
        R, t, s = optimize_sim3_transform(
            rot_12, trans_12, scale_12,
            np.array(pts1), np.array(pts2), np.array(obs1), np.array(obs2),
            np.array(s1), np.array(s2),
            p.loopClosureInlierThreshold, p.loopClosureRansacFixScale,
            device=self.device)
        return se3.Sim3(R, t, s)

    # ------------------------------------------------------------------

    def correct_loop(self, current_kf: Keyframe, loop_closure: LoopClosure) -> None:
        """reference: loop_closer.cpp:380-561"""
        self._step_wait("Starting loop closure.")     # loop_closer.cpp:382-386
        parameters = self.settings.parameters.slam
        map_db = self.map_db
        candidate_kf = map_db.keyframes[loop_closure.candidate_kf_id]

        first_kf_id = min(map_db.keyframes)
        if self.prev_loop_closure_kf_id.valid:
            self.prev_loop_closure_kf_id = _next_valid_kf_id(
                self.prev_loop_closure_kf_id, map_db)
        correction_start = max(first_kf_id,
                               max(self.prev_loop_closure_kf_id, candidate_kf.id))

        prev_poses: Dict[KfId, np.ndarray] = {
            kf_id: kf.pose_cw.copy() for kf_id, kf in map_db.keyframes.items()}

        T0 = se3.Sim3.identity()
        T = (se3.Sim3.from_se3(current_kf.pose_cw).inverse()
             * loop_closure.cand_to_curr
             * se3.Sim3.from_se3(candidate_kf.pose_cw))

        rigidly_transformed: List[KfId] = []
        if parameters.loopClosureRigidTransform:
            rigidly_transformed = current_kf.get_neighbors(
                map_db, parameters.minNeighbourCovisiblitities)
        rigidly_transformed.append(current_kf.id)

        local_map_points: Dict[MpId, KfId] = {}

        # rigid part (loop_closer.cpp:421-434)
        for kf_id in rigidly_transformed:
            kf = map_db.keyframes[kf_id]
            if kf.id < correction_start:
                continue
            kf.pose_cw = (se3.Sim3.from_se3(kf.pose_cw) * T).to_se3()
            for mp_val in kf.map_points:
                if mp_val >= 0 and MpId(int(mp_val)) not in local_map_points:
                    local_map_points[MpId(int(mp_val))] = kf.id

        self._step_wait("After rigid transform.")     # loop_closer.cpp:436-440

        # time-interpolated part (loop_closer.cpp:445-470)
        t0 = map_db.keyframes[correction_start].t
        t1 = current_kf.t
        for kf_id in sorted(map_db.keyframes, reverse=True):
            kf = map_db.keyframes[kf_id]
            if kf.id < correction_start:
                break
            if kf.id in rigidly_transformed:
                continue
            lam = 0.0 if t1 <= t0 else (kf.t - t0) / (t1 - t0)
            lam = min(max(lam, 0.0), 1.0)
            Tl = se3.interpolate_sim3(T0, T, lam)
            kf.pose_cw = (se3.Sim3.from_se3(kf.pose_cw) * Tl).to_se3()
            for mp_val in kf.map_points:
                if mp_val >= 0 and MpId(int(mp_val)) not in local_map_points:
                    local_map_points[MpId(int(mp_val))] = kf.id

        self._step_wait("After linear correction.")   # loop_closer.cpp:478-482

        map_db.loop_closure_edges.append(LoopClosureEdge(
            kf_id1=candidate_kf.id, kf_id2=current_kf.id,
            pose_diff=candidate_kf.pose_cw @ np.linalg.inv(current_kf.pose_cw)))

        reexpress_map_points(map_db, local_map_points, prev_poses,
                             self.settings)

        # global retriangulation (loop_closer.cpp:509-527), batched
        triangulate_map_points(map_db, list(map_db.map_points.values()),
                               self.settings)

        # merge matched map-point pairs (loop_closer.cpp:531-546)
        merged = set()
        for a, b in loop_closure.map_point_matches:
            if a == b or a in merged or b in merged:
                continue
            if a not in map_db.map_points or b not in map_db.map_points:
                continue
            merged.add(a)
            map_db.map_points[a].replace_with(map_db, map_db.map_points[b])

        self._search_and_deduplicate(candidate_kf, rigidly_transformed)
        self._step_wait("After map point manipulation.")  # loop_closer.cpp:552-555
        self.previous_closure_t = current_kf.t

    def get_total_reprojection_error(self) -> float:
        """Debug metric: summed squared reprojection error over every
        observation (reference: loop_closer.cpp:611-630)."""
        total = 0.0
        for kf in self.map_db.keyframes.values():
            sel = np.where(kf.map_points >= 0)[0]
            if len(sel) == 0:
                continue
            positions = np.stack([self.map_db.map_points[MpId(int(v))].position
                                  for v in kf.map_points[sel]])
            pix, _ = kf.reproject_many(positions)
            total += float(np.sum((pix - kf.shared.pts[sel]) ** 2))
        return total

    def _search_and_deduplicate(self, candidate_kf: Keyframe,
                                rigidly_transformed: List[KfId]) -> None:
        """reference: loop_closer.cpp:567-591"""
        parameters = self.settings.parameters.slam
        map_db = self.map_db
        loop_map_points = set()
        for kf_id in candidate_kf.get_neighbors(
                map_db, parameters.minNeighbourCovisiblitities, False):
            kf = map_db.keyframes[kf_id]
            for mp_val in kf.map_points:
                if mp_val < 0:
                    continue
                mp = map_db.map_points[MpId(int(mp_val))]
                if mp.status in (MapPointStatus.BAD, MapPointStatus.NOT_TRIANGULATED):
                    continue
                loop_map_points.add(mp.id)
        for kf_id in rigidly_transformed:
            kf = map_db.keyframes.get(kf_id)
            if kf is not None:
                matcher.replace_duplication(kf, sorted(loop_map_points), 4,
                                            map_db, self.settings)


def drift_gate_angle(U: np.ndarray, cand_pose_cw: np.ndarray,
                     curr_pose_cw: np.ndarray) -> float:
    """Drift angle of a loop-closure correction.

    The relative rotation between the candidate-implied pose of the current
    keyframe and its actual pose (reference: loop_closer.cpp:306-309,
    ``R = (U*candPose).inverse().topLeft().transpose()
    * currPose.inverse().topLeft()``). For a genuine small correction this is
    near identity regardless of the absolute orientation; ``U`` may carry a
    Sim3 scale in its rotation block, which the polar projection removes.
    """
    R = (np.linalg.inv(U @ cand_pose_cw)[:3, :3].T
         @ np.linalg.inv(curr_pose_cw)[:3, :3])
    return float(np.linalg.norm(se3.so3_log(_closest_rotation(R))))


def _closest_rotation(R: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(R)
    out = U @ Vt
    if np.linalg.det(out) < 0:
        out = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    return out
