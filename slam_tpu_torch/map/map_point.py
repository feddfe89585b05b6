"""Map point (landmark) record.

Rebuild of the reference ``MapPoint`` (reference: map_point.{hpp,cpp}):
position, status, observation map, representative descriptor (medoid by
median Hamming distance), viewing cone and scale prediction.
"""
from __future__ import annotations

import enum
import math
from typing import Dict, Iterable, Set, TYPE_CHECKING

import numpy as np

from slam_tpu_torch.ids import KfId, KpId, MpId, TrackId, NO_TRACK
from slam_tpu_torch.ops.hamming import hamming_matrix_host
from slam_tpu_torch.params import StaticSettings

if TYPE_CHECKING:
    from slam_tpu_torch.map.mapdb import MapDB


class MapPointStatus(enum.IntEnum):
    """reference: map_point.hpp:21"""
    TRIANGULATED = 0
    NOT_TRIANGULATED = 1
    UNSURE = 2
    BAD = 3


_MIRRORED = frozenset(("status", "position", "norm", "min_viewing_distance",
                       "max_viewing_distance", "descriptor"))


class MapPoint:
    # fixed attribute set: map points are created by the hundreds per
    # keyframe inside createNewMapPoints, and slot objects allocate/access
    # measurably faster than dict-backed ones on that path
    __slots__ = ("id", "track_id", "status", "position", "norm",
                 "min_viewing_distance", "max_viewing_distance", "descriptor",
                 "observations", "reference_keyframe", "color",
                 "_store", "_row")

    def __init__(self, mp_id: MpId = MpId(-1), keyframe_id: KfId = KfId(-1),
                 keypoint_id: KpId = KpId(-1)):
        object.__setattr__(self, "_store", None)
        object.__setattr__(self, "_row", -1)
        self.id = mp_id
        self.track_id: TrackId = NO_TRACK
        self.status = MapPointStatus.NOT_TRIANGULATED
        self.position = np.zeros(3)
        self.norm = np.zeros(3, np.float32)
        self.min_viewing_distance = 0.0
        self.max_viewing_distance = 30.0
        self.descriptor = np.zeros(8, np.uint32)
        self.observations: Dict[KfId, KpId] = {}
        self.reference_keyframe = keyframe_id
        self.color = np.zeros(3, np.uint8)
        if keyframe_id.valid:
            self.add_observation(keyframe_id, keypoint_id)

    def __setattr__(self, name, value):
        # write-through into the owning MapDB's columnar store (map/mp_store
        # .py) so pipeline stages read vectorized columns instead of walking
        # objects; registration happens when the point enters MapDB
        object.__setattr__(self, name, value)
        store = self._store
        if store is not None and name in _MIRRORED:
            getattr(store, name)[self._row] = (
                int(value) if name == "status" else value)

    # ------------------------------------------------------------------

    def add_observation(self, keyframe_id: KfId, keypoint_id: KpId) -> None:
        assert keyframe_id not in self.observations
        store = self._store
        if store is not None:
            store.covis_link(keyframe_id, self.observations)
        self.observations[keyframe_id] = keypoint_id
        if store is not None:
            row = self._row
            store.n_obs[row] += 1
            fk = store.first_kf[row]
            if fk < 0 or int(keyframe_id) < fk:
                store.first_kf[row] = int(keyframe_id)

    def set_observation(self, keyframe_id: KfId, keypoint_id: KpId) -> None:
        """Insert-or-replace (used by merge rewiring, mapdb.cpp:193-222)."""
        if keyframe_id in self.observations:
            self.observations[keyframe_id] = keypoint_id
        else:
            self.add_observation(keyframe_id, keypoint_id)

    def erase_observation(self, keyframe_id: KfId) -> None:
        assert keyframe_id in self.observations
        del self.observations[keyframe_id]
        store = self._store
        if store is not None:
            store.covis_unlink(keyframe_id, self.observations)
            row = self._row
            store.n_obs[row] -= 1
            if store.first_kf[row] == int(keyframe_id):
                store.first_kf[row] = (int(min(self.observations))
                                       if self.observations else -1)

    def get_first_observation(self) -> KfId:
        assert self.observations
        return min(self.observations)

    def get_last_observation(self) -> KfId:
        assert self.observations
        return max(self.observations)

    # ------------------------------------------------------------------

    def update_descriptor(self, map_db: "MapDB") -> None:
        """Medoid descriptor by median Hamming distance
        (reference: map_point.cpp:75-116)."""
        descs = []
        for kf_id in sorted(self.observations):
            kf = map_db.keyframes[kf_id]
            if kf.has_full_features:
                descs.append(kf.shared.descriptors[int(self.observations[kf_id])])
        if not descs:
            return
        # for n <= 2 the medoid is always the first descriptor (every row's
        # median is the self-distance 0; strict < keeps the first index)
        if len(descs) <= 2:
            self.descriptor = np.asarray(descs[0]).copy()
            return
        from slam_tpu_torch import native
        d = np.stack(descs)
        # reference keeps the first index achieving the best median (strict <)
        self.descriptor = d[native.medoid_descriptor(d)].copy()

    def replace_with(self, map_db: "MapDB", other: "MapPoint") -> None:
        """Merge this point into ``other`` (reference: map_point.cpp:118-156)."""
        assert self.id.valid and self.id in map_db.map_points
        assert other.id.valid and other.id in map_db.map_points
        if other.id == self.id:
            return
        if self.track_id.valid:
            if not other.track_id.valid:
                map_db.track_id_to_map_point[self.track_id] = other.id
                other.track_id = self.track_id
            else:
                del map_db.track_id_to_map_point[self.track_id]
        for kf_id, kp_id in list(self.observations.items()):
            kf = map_db.keyframes[kf_id]
            kf.keypoint_to_track.pop(kp_id, None)
            if kf_id not in other.observations:
                kf.map_points[int(kp_id)] = int(other.id)
                other.add_observation(kf_id, kp_id)
            else:
                kf.map_points[int(kp_id)] = -1
        self.status = MapPointStatus.BAD
        del map_db.map_points[self.id]

    def update_distance_and_norm(self, map_db: "MapDB",
                                 settings: StaticSettings) -> None:
        """Viewing normal + min/max distance (reference: map_point.cpp:158-172)."""
        norm_sum = np.zeros(3)
        for kf_id in sorted(self.observations):
            kf = map_db.keyframes[kf_id]
            v = kf.camera_center() - self.position
            n = np.linalg.norm(v)
            if n > 0:
                norm_sum += v / n
        self.norm = (norm_sum / len(self.observations)).astype(np.float32)
        first_kf = map_db.keyframes[self.get_first_observation()]
        dist = float(np.linalg.norm(first_kf.camera_center() - self.position))
        kp = int(self.observations[first_kf.id])
        octave = int(first_kf.shared.octave[kp])
        sf = settings.scaleFactors
        self.max_viewing_distance = dist * float(sf[octave])
        self.min_viewing_distance = dist * float(sf[octave]) / float(sf[-1])

    def predict_scale_level(self, dist: float, settings: StaticSettings) -> int:
        """reference: map_point.cpp:174-183"""
        ratio = self.max_viewing_distance / dist
        scale = math.ceil(math.log(ratio) / math.log(
            settings.parameters.slam.orbScaleFactor))
        return min(max(scale, 0), len(settings.scaleFactors) - 1)

    @staticmethod
    def predict_scale_levels(max_viewing_distances: np.ndarray,
                             dists: np.ndarray,
                             settings: StaticSettings) -> np.ndarray:
        """Vectorized predict_scale_level over many (map point, distance)
        pairs (same math; used by the batched matchers)."""
        ratio = np.asarray(max_viewing_distances, np.float64) / np.asarray(
            dists, np.float64)
        scale = np.ceil(np.log(ratio) / math.log(
            settings.parameters.slam.orbScaleFactor))
        return np.clip(scale, 0, len(settings.scaleFactors) - 1).astype(np.int64)

    def copy_for_active(self, active_keyframes: Set[KfId]) -> "MapPoint":
        """Partial copy dropping links to inactive keyframes
        (reference: map_point.cpp:22-43)."""
        mp = MapPoint()
        mp.id = self.id
        mp.track_id = self.track_id
        mp.status = self.status
        mp.position = self.position.copy()
        mp.norm = self.norm.copy()
        mp.min_viewing_distance = self.min_viewing_distance
        mp.max_viewing_distance = self.max_viewing_distance
        mp.descriptor = self.descriptor.copy()
        mp.color = self.color
        mp.observations = {k: v for k, v in self.observations.items()
                           if k in active_keyframes}
        if self.reference_keyframe in active_keyframes:
            mp.reference_keyframe = self.reference_keyframe
        else:
            mp.reference_keyframe = next(iter(sorted(mp.observations)))
        return mp

    def copy(self) -> "MapPoint":
        mp = MapPoint()
        mp.id = self.id
        mp.track_id = self.track_id
        mp.status = self.status
        mp.position = self.position.copy()
        mp.norm = self.norm.copy()
        mp.min_viewing_distance = self.min_viewing_distance
        mp.max_viewing_distance = self.max_viewing_distance
        mp.descriptor = self.descriptor.copy()
        mp.color = self.color
        mp.observations = dict(self.observations)
        mp.reference_keyframe = self.reference_keyframe
        return mp
