"""Map database: keyframe/map-point registries and pose chaining.

Rebuild of the reference ``MapDB`` (reference: mapdb.{hpp,cpp}) including the
pose-seeding delta chain of ``insertNewKeyframeCandidate`` (mapdb.cpp:35-96),
full/partial deep copies powering the frontend map snapshot (mapdb.cpp:98-159),
map-point removal/merging, and ``updatePrevPose`` (mapdb.cpp:231-267).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.ids import KfId, KpId, MapId, MpId, TrackId, CURRENT_MAP_ID
from slam_tpu_torch.map.keyframe import Keyframe, Pose
from slam_tpu_torch.map.map_point import MapPoint
from slam_tpu_torch.map.mp_store import MpStore
from slam_tpu_torch.params import Parameters, ParametersSlam


class _MpDict(dict):
    """``map_points`` registry that keeps the columnar ``MpStore`` in sync:
    every insert adopts the point into the store (allocating its row), every
    delete releases it. All pipeline mutation paths go through item
    assignment / ``del`` on this dict."""

    __slots__ = ("store",)

    def __init__(self, store: MpStore):
        super().__init__()
        self.store = store

    def __setitem__(self, mp_id, mp):
        assert mp_id not in self, "map point ids are never reused"
        super().__setitem__(mp_id, mp)
        self.store.adopt(mp)

    def __delitem__(self, mp_id):
        mp = self[mp_id]
        super().__delitem__(mp_id)
        self.store.release(mp)

    def pop(self, *a, **k):  # pragma: no cover - keep the registry coherent
        raise NotImplementedError("use del map_points[id]")


class LoopStage(enum.IntEnum):
    """reference: loop_closer.hpp:23-30"""
    BOW_MATCH = 0
    QUICK_TESTS = 1
    MAP_POINT_MATCHES = 2
    ACCEPTED = 3
    RELOCATION_MAP_POINT_MATCHES = 4
    RELOCATION_MAP_POINT_RANSAC = 5


@dataclasses.dataclass
class LoopClosureEdge:
    """reference: loop_closer.hpp:32-43"""
    kf_id1: KfId
    kf_id2: KfId
    pose_diff: np.ndarray


@dataclasses.dataclass(frozen=True, order=True)
class MapKf:
    """reference: bow_index.hpp:23-26"""
    map_id: MapId
    kf_id: KfId


@dataclasses.dataclass
class MapPointRecordPosition:
    t: float
    p: np.ndarray


@dataclasses.dataclass
class MapPointRecord:
    """Map-point time series for offline analysis
    (reference: api/slam_map_point_record.hpp via mapper_helpers.cpp:881-909)."""
    positions: List[MapPointRecordPosition]
    normal: np.ndarray
    kind: str = "slam"
    removed: bool = False


def _find_in_pose_trail(pose_trail: List[Pose], kf_id: KfId) -> Optional[Pose]:
    for pose in pose_trail:
        if int(kf_id) == pose.frame_number:
            return pose
    return None


class MapDB:
    def __init__(self):
        self.keyframes: Dict[KfId, Keyframe] = {}
        self.mp_store = MpStore()
        self.map_points: Dict[MpId, MapPoint] = _MpDict(self.mp_store)
        self.track_id_to_map_point: Dict[TrackId, MpId] = {}
        self.loop_closure_edges: List[LoopClosureEdge] = []
        self.discarded_uncertainty = np.zeros((3, 6))
        self.first_kf_timestamp = -1.0

        # visualization conveniences (reference: mapdb.hpp:66-68)
        self.loop_stages: Dict[MapKf, LoopStage] = {}
        self.adjacent_kf_ids: List[KfId] = []
        self.map_point_records: Dict[MpId, MapPointRecord] = {}

        self._prev_pose = np.eye(4)
        self._prev_input_pose = np.eye(4)
        self._prev_pose_to_prev_keyframe_delta = np.eye(4)
        self._next_mp = 0
        self._prev_pose_kf_id = KfId(-1)
        self._last_kf_candidate_id = KfId(-1)
        self._last_kf_id = KfId(-1)

    # ------------------------------------------------------------------

    def latest_keyframe(self) -> Optional[Keyframe]:
        if self._last_kf_id.valid:
            return self.keyframes.get(self._last_kf_id)
        return None

    def last_keyframe_candidate_id(self) -> KfId:
        return self._last_kf_candidate_id

    def next_mp_id(self) -> MpId:
        self._next_mp += 1
        return MpId(self._next_mp - 1)

    def max_ids(self) -> Tuple[KfId, MpId]:
        kf = max(self.keyframes, default=KfId(-1))
        mp = max(self.map_points, default=MpId(-1))
        return KfId(int(kf)), MpId(int(mp))

    # ------------------------------------------------------------------

    def insert_new_keyframe_candidate(self, keyframe: Keyframe,
                                      keyframe_decision: bool,
                                      pose_trail: List[Pose],
                                      parameters: ParametersSlam) -> Keyframe:
        """Insert with delta-chained pose seeding (reference: mapdb.cpp:35-96)."""
        previous_kf = self.latest_keyframe()

        if not self._prev_pose_kf_id.valid:
            pose = keyframe.orig_pose_cw.copy()
        else:
            assert previous_kf is not None
            ref_pose = self._prev_pose
            if parameters.useVariableLengthDeltas:
                ref_pose = self._prev_pose_to_prev_keyframe_delta @ previous_kf.pose_cw
            ref_prev_pose = self._prev_input_pose
            if parameters.useOdometryPoseTrailDelta:
                in_trail = _find_in_pose_trail(pose_trail, self._prev_pose_kf_id)
                if in_trail is None:
                    pass  # keep prev input pose (reference logs and falls back)
                else:
                    assert KfId(in_trail.frame_number) != keyframe.id
                    ref_prev_pose = in_trail.pose_cw
            pose_tilted = keyframe.orig_pose_cw @ np.linalg.inv(ref_prev_pose) @ ref_pose
            if parameters.removeOdometryTransformZAxisTilt:
                ref = keyframe.orig_pose_cw
                ref_rot = ref[:3, :3]
                new_rot = ref_rot @ se3.remove_rotation_z_tilt(
                    np.linalg.inv(ref_rot) @ pose_tilted[:3, :3])
                pose = se3.replace_pose_orientation_keep_position(pose_tilted, new_rot)
            else:
                pose = pose_tilted

        keyframe.pose_cw = pose
        if previous_kf is not None:
            keyframe.previous_kf_id = previous_kf.id
            previous_kf.next_kf_id = keyframe.id

        self._last_kf_candidate_id = keyframe.id
        if keyframe_decision:
            self._last_kf_id = keyframe.id
        if self.first_kf_timestamp < 0:
            self.first_kf_timestamp = keyframe.t
        self.keyframes[keyframe.id] = keyframe
        return keyframe

    def update_prev_pose(self, current_keyframe: Keyframe, keyframe_decision: bool,
                         pose_trail: List[Pose], parameters: Parameters) -> None:
        """reference: mapdb.cpp:231-267"""
        p = parameters.slam
        if (not keyframe_decision and p.useVariableLengthDeltas
                and _find_in_pose_trail(pose_trail, self._prev_pose_kf_id) is None):
            keyframe_decision = True
        if not keyframe_decision and p.useVariableLengthDeltas:
            next_kf_candidate_age = (int(current_keyframe.id) - int(self._prev_pose_kf_id)
                                     + p.keyframeCandidateInterval)
            assert next_kf_candidate_age > 0
            max_pose_trail_size = (p.cameraTrailLength
                                   - max(0, p.delayIntervalMultiplier) * p.keyframeCandidateInterval)
            if not (p.useOdometryPoseTrailDelta
                    and next_kf_candidate_age >= max_pose_trail_size):
                return
        self._prev_pose_kf_id = current_keyframe.id
        self._prev_input_pose = current_keyframe.orig_pose_cw.copy()
        self._prev_pose = current_keyframe.pose_cw.copy()
        prev_kf = self.latest_keyframe()
        assert prev_kf is not None
        self._prev_pose_to_prev_keyframe_delta = (
            self._prev_pose @ np.linalg.inv(prev_kf.pose_cw))

    def refresh_prev_pose(self) -> None:
        """Re-sync the prev-pose snapshot with the live keyframe pose.

        Used by the pipelined (deferred-apply) local BA: ``update_prev_pose``
        snapshots ``pose_cw`` at frame end, but a deferred BA applies its
        refinement afterwards; this re-reads the pose so the next frame's
        delta-chained seed (``insert_new_keyframe_candidate``) matches the
        synchronous pipeline."""
        kf = self.keyframes.get(self._prev_pose_kf_id)
        if kf is not None:
            self._prev_pose = kf.pose_cw.copy()

    # ------------------------------------------------------------------

    def remove_map_point(self, map_point: MapPoint) -> None:
        """reference: mapdb.cpp:161-174"""
        for kf_id in list(map_point.observations):
            self.keyframes[kf_id].erase_observation(map_point.id)
        if map_point.track_id.valid:
            assert self.track_id_to_map_point[map_point.track_id] == map_point.id
            del self.track_id_to_map_point[map_point.track_id]
        del self.map_points[map_point.id]

    def merge_map_points(self, mp_id1: MpId, mp_id2: MpId) -> None:
        """Keep the lower id, rewire observations (reference: mapdb.cpp:193-222)."""
        assert mp_id1 != mp_id2
        first = min(mp_id1, mp_id2)
        last = max(mp_id1, mp_id2)
        first_mp = self.map_points[first]
        last_mp = self.map_points[last]
        last_track = last_mp.track_id
        for kf in self.keyframes.values():
            assert len(kf.map_points) == kf.shared.num_keypoints
            hits = np.where(kf.map_points == int(last))[0]
            if len(hits):
                i = int(hits[0])
                kp_id = KpId(i)
                kf.map_points[i] = int(first)
                if kp_id in kf.keypoint_to_track:
                    kf.keypoint_to_track[kp_id] = first_mp.track_id
                first_mp.set_observation(kf.id, kp_id)
        if last_track.valid:
            del self.track_id_to_map_point[last_track]
        del self.map_points[last]

    def pose_difference(self, kf_id1: KfId, kf_id2: KfId) -> np.ndarray:
        """reference: mapdb.cpp:224-229"""
        assert kf_id1 <= kf_id2
        kf1 = self.keyframes[kf_id1]
        kf2 = self.keyframes[kf_id2]
        return kf1.orig_pose_cw @ np.linalg.inv(kf2.orig_pose_cw)

    # ------------------------------------------------------------------
    # copies (reference: mapdb.cpp:98-159)
    # ------------------------------------------------------------------

    def copy(self) -> "MapDB":
        out = MapDB()
        for kf_id, kf in self.keyframes.items():
            out.keyframes[kf_id] = kf.copy()
        for mp_id, mp in self.map_points.items():
            out.map_points[mp_id] = mp.copy()
        out.track_id_to_map_point = dict(self.track_id_to_map_point)
        out.loop_closure_edges = list(self.loop_closure_edges)
        out._prev_pose = self._prev_pose.copy()
        out._prev_input_pose = self._prev_input_pose.copy()
        out._prev_pose_to_prev_keyframe_delta = self._prev_pose_to_prev_keyframe_delta.copy()
        out.discarded_uncertainty = self.discarded_uncertainty.copy()
        out._next_mp = self._next_mp
        out._prev_pose_kf_id = self._prev_pose_kf_id
        out._last_kf_candidate_id = self._last_kf_candidate_id
        out._last_kf_id = self._last_kf_id
        out.first_kf_timestamp = self.first_kf_timestamp
        return out

    def copy_partial(self, active_keyframes: Set[KfId]) -> "MapDB":
        out = MapDB()
        active_mps: Set[MpId] = set()
        for kf_id in sorted(active_keyframes):
            kf = self.keyframes[kf_id].copy()
            if kf.next_kf_id.valid and kf.next_kf_id not in active_keyframes:
                kf.next_kf_id = KfId(-1)
            if kf.previous_kf_id.valid and kf.previous_kf_id not in active_keyframes:
                kf.previous_kf_id = KfId(-1)
            out.keyframes[kf_id] = kf
            for mp_id in kf.map_points:
                if mp_id >= 0:
                    active_mps.add(MpId(int(mp_id)))
        for mp_id in active_mps:
            out.map_points[mp_id] = self.map_points[mp_id].copy_for_active(active_keyframes)
        out.track_id_to_map_point = {
            t: m for t, m in self.track_id_to_map_point.items() if m in active_mps}
        out._prev_pose = self._prev_pose.copy()
        out._prev_input_pose = self._prev_input_pose.copy()
        out._prev_pose_to_prev_keyframe_delta = self._prev_pose_to_prev_keyframe_delta.copy()
        out.discarded_uncertainty = self.discarded_uncertainty.copy()
        out._next_mp = self._next_mp
        out._prev_pose_kf_id = self._prev_pose_kf_id
        out._last_kf_candidate_id = self._last_kf_candidate_id
        out._last_kf_id = self._last_kf_id
        out.first_kf_timestamp = self.first_kf_timestamp
        return out


Atlas = List[MapDB]


def get_map_with_id(map_id: MapId, map_db: MapDB, atlas: Atlas) -> MapDB:
    """reference: mapdb.cpp:269-272"""
    if map_id == CURRENT_MAP_ID:
        return map_db
    return atlas[int(map_id)]
