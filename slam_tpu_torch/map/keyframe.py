"""Keyframe and shared per-frame feature data.

Rebuild of the reference ``Keyframe`` / ``KeyframeShared``
(reference: keyframe.{hpp,cpp}). Feature data lives in packed NumPy arrays
(TPU-friendly struct-of-arrays instead of the reference's vector<KeyPoint>),
shared between frontend/backend copies exactly like ``KeyframeShared``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, TYPE_CHECKING

import numpy as np

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.geometry.camera import Camera
from slam_tpu_torch.ids import KfId, KpId, MpId, TrackId, NO_MP
from slam_tpu_torch.map.feature_search import FeatureSearch
from slam_tpu_torch.params import StaticSettings

if TYPE_CHECKING:
    from slam_tpu_torch.map.mapdb import MapDB
    from slam_tpu_torch.map.map_point import MapPoint


@dataclasses.dataclass
class MapperInput:
    """Per-frame input from the host VIO system
    (reference: keyframe.hpp:31-44 ``MapperInput``)."""
    # grayscale frame (H, W) uint8; None when only tracked features are used
    frame: Optional[np.ndarray]
    camera: Camera
    # tracked features: ids (K,), positions (K, 2), optional per-track depth (K,)
    track_ids: np.ndarray
    track_pts: np.ndarray
    track_depths: Optional[np.ndarray]
    # pose trail: list of (frame_number, t, pose_cw (4,4), uncertainty (3,6));
    # index 0 is the current frame (reference: slam::Pose)
    pose_trail: List["Pose"]
    t: float
    color_frame: Optional[np.ndarray] = None
    # optional dense depth map aligned with `frame`
    depth_map: Optional[np.ndarray] = None
    # optional stereo point cloud in camera coords (M, 3) float32
    stereo_point_cloud: Optional[np.ndarray] = None

    def get_depth(self, pt: np.ndarray) -> float:
        if self.depth_map is None:
            return -1.0
        x, y = int(round(float(pt[0]))), int(round(float(pt[1])))
        h, w = self.depth_map.shape
        if 0 <= x < w and 0 <= y < h:
            return float(self.depth_map[y, x])
        return -1.0


@dataclasses.dataclass
class Pose:
    """One pose-trail entry (reference: api Pose used via poseTrail)."""
    frame_number: int
    t: float
    pose_cw: np.ndarray
    uncertainty: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((3, 6)))


class KeyframeShared:
    """Immutable-ish feature block shared between keyframe copies
    (reference: keyframe.hpp:50-106)."""

    def __init__(self):
        self.camera: Optional[Camera] = None
        self.pts = np.zeros((0, 2), np.float32)
        self.octave = np.zeros(0, np.int32)
        self.angle = np.zeros(0, np.float32)
        self.descriptors = np.zeros((0, 8), np.uint32)
        self.bearings = np.zeros((0, 3), np.float64)
        # retrieval data (BoW equivalent): per-keypoint word + group id and a
        # normalized word-histogram signature (see ops/bow.py)
        self.words = np.zeros(0, np.int32)
        self.groups = np.zeros(0, np.int32)
        # sparse retrieval signature: (unique word ids, L2-normalized
        # weights) pair, see ops/bow.BowIndex.transform
        self.bow_signature = None
        self.feature_search: Optional[FeatureSearch] = None
        self.colors: Optional[np.ndarray] = None
        self.stereo_point_cloud: Optional[np.ndarray] = None
        # debug frame retained ONLY when a publisher asks for the map-point-
        # search view (reference: kf.shared->imgDbg, populated mapper.cpp:370)
        self.img_dbg: Optional[np.ndarray] = None
        self._npix: Optional[np.ndarray] = None
        self._nok: Optional[np.ndarray] = None

    @property
    def num_keypoints(self) -> int:
        return len(self.pts)

    def normalized_pixels(self):
        """Cached ``camera.normalize_pixel`` over all keypoints (valid once
        features are populated; keypoints are immutable afterwards).
        Returns (npix (n,2) float64, ok (n,) uint8)."""
        if self._npix is None or len(self._npix) != len(self.pts):
            npix, nok = self.camera.normalize_pixel(self.pts)
            self._npix = np.ascontiguousarray(npix, np.float64)
            self._nok = np.ascontiguousarray(nok, np.uint8)
        return self._npix, self._nok

    def clone(self) -> "KeyframeShared":
        """Fresh copy for the other pipeline half; must be called before
        features are populated (reference: keyframe.cpp:149-162)."""
        assert self.num_keypoints == 0 and self.feature_search is None
        s = KeyframeShared()
        s.camera = self.camera
        s.stereo_point_cloud = self.stereo_point_cloud
        return s


class Keyframe:
    """One map node (reference: keyframe.hpp:108-206)."""

    def __init__(self, mapper_input: Optional[MapperInput] = None):
        self.shared = KeyframeShared()
        self.id = KfId(-1)
        self.previous_kf_id = KfId(-1)
        self.next_kf_id = KfId(-1)
        self.keypoint_to_track: Dict[KpId, TrackId] = {}
        self.map_points = np.zeros(0, np.int64)  # MpId value per keypoint, -1 = none
        self.keypoint_depth = np.zeros(0, np.float32)
        self.pose_cw = np.eye(4)
        self.orig_pose_cw = np.eye(4)
        self.uncertainty = np.zeros((3, 6))
        self.t = 0.0
        self.has_full_features = False
        if mapper_input is not None:
            p0 = mapper_input.pose_trail[0]
            self.id = KfId(p0.frame_number)
            self.orig_pose_cw = np.array(p0.pose_cw)
            self.uncertainty = np.array(p0.uncertainty)
            self.t = p0.t
            self.shared.camera = mapper_input.camera
            self.shared.stereo_point_cloud = mapper_input.stereo_point_cloud

    # ------------------------------------------------------------------
    # feature population (reference: keyframe.cpp:95-133)
    # ------------------------------------------------------------------

    def add_full_features(self, mapper_input: MapperInput, orb_extractor,
                          bow_index=None) -> None:
        """Run the ORB front-end and fill the shared feature block
        (reference: keyframe.cpp:95-116)."""
        self.has_full_features = True
        res = orb_extractor.detect_and_extract(
            mapper_input.frame, mapper_input.track_pts, mapper_input.track_ids,
            key=mapper_input.pose_trail[0].frame_number)
        cam = self.shared.camera
        valid = res.valid & cam.is_valid_pixel(res.pts)
        c = valid
        self.shared.pts = res.pts[c]
        self.shared.octave = res.octave[c]
        self.shared.angle = res.angle[c]
        self.shared.descriptors = res.descriptors[c]
        if res.words is not None:
            # BoW words quantized on-device inside the fused front-end
            self.shared.words = res.words[c]
        tids = res.track_ids[c]
        for i, tid in enumerate(tids):
            if tid >= 0:
                self.keypoint_to_track[KpId(i)] = TrackId(int(tid))
        self._process_keypoints(mapper_input)
        self.shared.feature_search = FeatureSearch(self.shared.pts)
        if bow_index is not None:
            bow_index.transform(self.shared)

    def add_tracker_features(self, mapper_input: MapperInput) -> None:
        """Tracked-features-only path for non-keyframes / frontend
        (reference: keyframe.cpp:118-133)."""
        cam = self.shared.camera
        pts = np.asarray(mapper_input.track_pts, np.float32).reshape(-1, 2)
        ids = np.asarray(mapper_input.track_ids, np.int64).reshape(-1)
        keep = cam.is_valid_pixel(pts) if len(pts) else np.zeros(0, bool)
        self.shared.pts = pts[keep]
        self.shared.octave = np.zeros(len(self.shared.pts), np.int32)
        self.shared.angle = np.zeros(len(self.shared.pts), np.float32)
        self.shared.descriptors = np.zeros((len(self.shared.pts), 8), np.uint32)
        for i, tid in enumerate(ids[keep]):
            self.keypoint_to_track[KpId(i)] = TrackId(int(tid))
        self._process_keypoints(mapper_input)

    def _process_keypoints(self, mapper_input: MapperInput) -> None:
        """Depth lookup + pixel->bearing (reference: keyframe.cpp:34-69)."""
        n = self.shared.num_keypoints
        self.map_points = np.full(n, -1, np.int64)
        depths = np.full(n, -1.0, np.float32)
        track_depth = {}
        if mapper_input.track_depths is not None:
            for tid, d in zip(mapper_input.track_ids, mapper_input.track_depths):
                track_depth[int(tid)] = float(d)
        for kp_idx in range(n):
            d = -1.0
            tid = self.keypoint_to_track.get(KpId(kp_idx))
            if tid is not None:
                d = track_depth.get(int(tid), -1.0)
            if d < 0:
                d = mapper_input.get_depth(self.shared.pts[kp_idx])
            depths[kp_idx] = d
        self.keypoint_depth = depths
        rays, ok = self.shared.camera.pixel_to_ray(self.shared.pts)
        assert bool(np.all(ok)), "invalid keypoints must be filtered before this"
        self.shared.bearings = rays
        if mapper_input.color_frame is not None and n:
            img = mapper_input.color_frame
            h, w = img.shape[:2]
            xs = np.clip(self.shared.pts[:, 0].astype(int), 0, w - 1)
            ys = np.clip(self.shared.pts[:, 1].astype(int), 0, h - 1)
            self.shared.colors = np.asarray(img[ys, xs]).reshape(n, -1)

    def copy(self) -> "Keyframe":
        """Copy sharing the feature block (reference: keyframe.cpp:135-147)."""
        kf = Keyframe()
        kf.shared = self.shared
        kf.id = self.id
        kf.previous_kf_id = self.previous_kf_id
        kf.next_kf_id = self.next_kf_id
        kf.keypoint_to_track = dict(self.keypoint_to_track)
        kf.map_points = self.map_points.copy()
        kf.keypoint_depth = self.keypoint_depth.copy()
        kf.pose_cw = self.pose_cw.copy()
        kf.orig_pose_cw = self.orig_pose_cw.copy()
        kf.uncertainty = self.uncertainty.copy()
        kf.t = self.t
        kf.has_full_features = self.has_full_features
        return kf

    # ------------------------------------------------------------------
    # geometry helpers
    # ------------------------------------------------------------------

    def camera_center(self) -> np.ndarray:
        return se3.camera_center(self.pose_cw)

    def orig_pose_camera_center(self) -> np.ndarray:
        return se3.camera_center(self.orig_pose_cw)

    def camera_to_world_rotation(self) -> np.ndarray:
        return self.pose_cw[:3, :3].T

    def reproject(self, point_w: np.ndarray):
        """World point -> (pixel, visible) (reference: keyframe.cpp:264-272)."""
        pc = self.pose_cw[:3, :3] @ np.asarray(point_w) + self.pose_cw[:3, 3]
        pix, ok = self.shared.camera.ray_to_pixel(pc)
        if not ok:
            return np.zeros(2), False
        if not self.shared.camera.is_valid_pixel(pix):
            return pix, False
        return pix, True

    def reproject_many(self, points_w: np.ndarray):
        """Vectorized reprojection of (M, 3) world points."""
        pts = np.asarray(points_w).reshape(-1, 3)
        pc = pts @ self.pose_cw[:3, :3].T + self.pose_cw[:3, 3]
        pix, ok = self.shared.camera.ray_to_pixel(pc)
        ok = ok & self.shared.camera.is_valid_pixel(pix)
        return pix, ok

    def is_in_frustum(self, mp: "MapPoint", view_angle_limit_cos: float = 0.5) -> bool:
        """Frustum + viewing-cone test (reference: keyframe.cpp:247-262)."""
        _, visible = self.reproject(mp.position)
        if not visible:
            return False
        mp_to_kf = (self.camera_center() - mp.position).astype(np.float32)
        dist = float(np.linalg.norm(mp_to_kf))
        if dist < mp.min_viewing_distance or dist > mp.max_viewing_distance:
            return False
        if dist > 0:
            viewing_cos = float(mp_to_kf @ mp.norm) / dist
        else:
            viewing_cos = 1.0
        return viewing_cos >= view_angle_limit_cos

    def get_features_around(self, point, r) -> np.ndarray:
        assert self.shared.feature_search is not None
        return self.shared.feature_search.get_features_around(
            float(point[0]), float(point[1]), float(r))

    def compute_median_depth(self, map_db: "MapDB", default_depth: float = 2.0) -> float:
        """Median z of triangulated observed points
        (reference: keyframe.cpp:164-190). One columnar gather + partition
        instead of a per-point attribute walk (same lower-median element)."""
        from slam_tpu_torch.map.map_point import MapPointStatus
        store = map_db.mp_store
        vals = self.map_points[self.map_points >= 0]
        rows, live = store.rows_of(vals)
        keep = live & (store.status[rows] == int(MapPointStatus.TRIANGULATED))
        if not keep.any():
            return default_depth
        depths = (store.position[rows[keep]] @ self.pose_cw[2, :3]
                  + self.pose_cw[2, 3])
        k = (len(depths) - 1) // 2
        return float(np.partition(depths, k)[k])

    def get_neighbors(self, map_db: "MapDB", min_covisibilities: int = 1,
                      triangulated_only: bool = False) -> List[KfId]:
        """Covisibility neighbors; prev/next always count
        (reference: keyframe.cpp:192-230).

        Fast path: the incremental pair counts maintained by the MpStore
        observation hooks (``mp_store.covis``) — identical to the scalar
        tally under the audited keyframe<->map-point link invariant, with
        the prev/next ``min_covisibilities`` floor meaning prev/next always
        qualify. The Counter recount remains for ``triangulated_only`` (the
        reference flag; unused in the pipeline) and as the audit reference
        in ``check_consistency``."""
        if not triangulated_only:
            counts = map_db.mp_store.covis.get(self.id)
            out = ({kf_id for kf_id, c in counts.items()
                    if c >= min_covisibilities} if counts else set())
            if self.previous_kf_id.valid:
                out.add(self.previous_kf_id)
            if self.next_kf_id.valid:
                out.add(self.next_kf_id)
            out.discard(self.id)
            return sorted(out)
        from collections import Counter
        from itertools import chain
        from slam_tpu_torch.map.map_point import MapPointStatus
        mpd = map_db.map_points
        vals = self.map_points
        mps = [mpd[v] for v in vals[vals >= 0].tolist()]
        obs_iter = (mp.observations for mp in mps
                    if mp.status == MapPointStatus.TRIANGULATED)
        covis = Counter(chain.from_iterable(obs_iter))
        if self.previous_kf_id.valid:
            covis[self.previous_kf_id] += min_covisibilities
        if self.next_kf_id.valid:
            covis[self.next_kf_id] += min_covisibilities
        return sorted(kf_id for kf_id, c in covis.items()
                      if kf_id != self.id and c >= min_covisibilities)

    # ------------------------------------------------------------------
    # observation bookkeeping (reference: keyframe.cpp:274-288)
    # ------------------------------------------------------------------

    def add_observation(self, mp_id: MpId, kp_id: KpId) -> None:
        assert self.map_points[int(kp_id)] == -1
        self.map_points[int(kp_id)] = int(mp_id)

    def erase_observation(self, mp_id: MpId) -> None:
        idx = np.where(self.map_points == int(mp_id))[0]
        assert len(idx) > 0, "MapPoint not observed in keyframe"
        kp = KpId(int(idx[0]))
        self.map_points[int(kp)] = -1
        self.keypoint_to_track.pop(kp, None)

    def get_keypoint_color(self, kp_id: KpId):
        if self.shared.colors is None:
            return np.zeros(3, np.uint8)
        return self.shared.colors[int(kp_id)]
