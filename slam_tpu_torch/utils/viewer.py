"""Viewer data publisher: thread-safe map snapshots for external rendering.

Rebuild of the reference observability stack (reference:
viewer_data_publisher.{hpp,cpp} — mutex-guarded snapshot store decoupling the
SLAM threads from render threads; opencv_viewer_data_publisher.cpp and
slam_viewer.cpp are the 2D/3D renderers). Instead of OpenCV/Pangolin windows,
snapshots are plain dictionaries that can be rendered by any external tool
and exported as JSON (``dump_json``) for offline visualization — the
TPU-appliance-friendly equivalent of a GUI.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

import numpy as np

from slam_tpu_torch.ids import KfId, MpId
from slam_tpu_torch.map.map_point import MapPointStatus


class ViewerParameters:
    """Visualization toggles (reference: the codegen'd cmd::ParametersSlam
    consulted via dataPublisher->getParameters(), viewer_data_publisher.hpp:
    100; only the fields this module reads)."""

    def __init__(self, visualizeMapPointSearch: bool = False):
        self.visualizeMapPointSearch = visualizeMapPointSearch


class ViewerDataPublisher:
    """reference: viewer_data_publisher.hpp:93-160"""

    def __init__(self, parameters: Optional[ViewerParameters] = None):
        self._lock = threading.Lock()
        self._map_points: List[dict] = []
        self._keyframes: List[dict] = []
        self._loop_stages: Dict[str, int] = {}
        self._loop_closures: List[dict] = []
        self._loop_closure_edges: List[dict] = []
        self._atlas: List[dict] = []
        self._age: float = -1.0
        self._map_point_search: Optional[dict] = None
        self.parameters = parameters if parameters is not None \
            else ViewerParameters()

    def get_parameters(self) -> ViewerParameters:
        return self.parameters

    # ------------------------------------------------------------------
    # producer side (SLAM threads)
    # ------------------------------------------------------------------

    def publish_map(self, map_db, workspace_ba, parameters) -> None:
        """Snapshot the map (reference: mapper_helpers.cpp:814-879
        publishMapForViewer)."""
        if not map_db.keyframes:
            return
        current = map_db.keyframes[max(map_db.keyframes)]
        visible = {int(v) for v in current.map_points if v >= 0}
        local_mps = (workspace_ba.local_mp_ids
                     if workspace_ba is not None else set())
        mps = []
        for mp in map_db.map_points.values():
            if mp.status == MapPointStatus.NOT_TRIANGULATED:
                continue
            mps.append({
                "position": mp.position.astype(float).tolist(),
                "normal": mp.norm.astype(float).tolist(),
                "color": np.asarray(mp.color, float).tolist(),
                "status": int(mp.status),
                "localMap": mp.id in local_mps,
                "nowVisible": int(mp.id) in visible,
            })
        adjacent = set(map_db.adjacent_kf_ids)
        index_of = {kf_id: i for i, kf_id in enumerate(sorted(map_db.keyframes))}
        kfs = []
        for kf_id in sorted(map_db.keyframes):
            kf = map_db.keyframes[kf_id]
            kfs.append({
                "id": int(kf.id),
                "localMap": kf.id in adjacent,
                "current": kf.id == current.id,
                "poseWC": np.linalg.inv(kf.pose_cw).tolist(),
                "origPoseWC": np.linalg.inv(kf.orig_pose_cw).tolist(),
                "neighbors": [index_of[n] for n in kf.get_neighbors(
                    map_db, parameters.minNeighbourCovisiblitities)
                    if n in index_of],
                "stereoPointCloud": (kf.shared.stereo_point_cloud.tolist()
                                     if kf.shared.stereo_point_cloud is not None
                                     else None),
            })
        stages = {f"{int(k.map_id)}:{int(k.kf_id)}": int(v)
                  for k, v in map_db.loop_stages.items()}
        # accepted loop-closure graph edges (reference: slam_viewer.cpp loop
        # edge rendering; LoopClosureEdge list, mapdb.hpp)
        lc_edges = [{"kfId1": int(e.kf_id1), "kfId2": int(e.kf_id2),
                     "poseDiff": np.asarray(e.pose_diff, float).tolist()}
                    for e in map_db.loop_closure_edges]
        age = float(int(map_db.last_keyframe_candidate_id()))
        with self._lock:
            self._map_points = mps
            self._keyframes = kfs
            self._loop_stages = stages
            self._loop_closure_edges = lc_edges
            self._age = age

    def add_loop_closure(self, current_pose_wc, candidate_pose_wc,
                         updated_pose_wc) -> None:
        """reference: viewer_data_publisher addLoopClosure"""
        with self._lock:
            self._loop_closures.append({
                "currentPose": np.asarray(current_pose_wc).tolist(),
                "candidatePose": np.asarray(candidate_pose_wc).tolist(),
                "updatedPose": np.asarray(updated_pose_wc).tolist(),
            })

    def visualize_map_point_search(self, frame, matched, projected_mps,
                                   unmatched_kps) -> None:
        """Snapshot one searchByProjection debug view (reference:
        opencv_viewer_data_publisher.cpp:210-246, fed from
        keyframe_matcher.cpp:307-410): ``matched`` = (mp reprojection,
        keypoint) pixel pairs, ``projected_mps`` = every candidate projection
        that landed in-image, ``unmatched_kps`` = keypoints left without a
        map point."""
        snap = {
            "frame": None if frame is None else np.asarray(frame),
            "matched": [(np.asarray(m, float).tolist(),
                         np.asarray(k, float).tolist()) for m, k in matched],
            "projectedMps": np.asarray(projected_mps, float).reshape(-1, 2)
                              .tolist(),
            "unmatchedKps": np.asarray(unmatched_kps, float).reshape(-1, 2)
                              .tolist(),
        }
        with self._lock:
            self._map_point_search = snap

    def get_map_point_search(self) -> Optional[dict]:
        with self._lock:
            return self._map_point_search

    def set_atlas(self, atlas) -> None:
        """reference: mapDBtoViewerAtlasMap (mapper_helpers.cpp:995-1009)"""
        out = []
        for m in atlas:
            out.append({
                "keyframes": [{"id": int(kf.id),
                               "poseWC": np.linalg.inv(kf.pose_cw).tolist()}
                              for kf in m.keyframes.values()],
                "mapPoints": [mp.position.astype(float).tolist()
                              for mp in m.map_points.values()],
            })
        with self._lock:
            self._atlas = out

    # ------------------------------------------------------------------
    # consumer side (render threads / exporters)
    # ------------------------------------------------------------------

    def get_map_points(self) -> List[dict]:
        with self._lock:
            return list(self._map_points)

    def get_keyframes(self) -> List[dict]:
        with self._lock:
            return list(self._keyframes)

    def get_loop_closures(self) -> List[dict]:
        with self._lock:
            return list(self._loop_closures)

    def get_loop_closure_edges(self) -> List[dict]:
        with self._lock:
            return list(self._loop_closure_edges)

    def get_atlas(self) -> List[dict]:
        with self._lock:
            return list(self._atlas)

    def get_age(self) -> float:
        with self._lock:
            return self._age

    def dump_json(self, path: str) -> None:
        with self._lock:
            snapshot = {
                "age": self._age,
                "mapPoints": self._map_points,
                "keyframes": self._keyframes,
                "loopStages": self._loop_stages,
                "loopClosures": self._loop_closures,
                "loopClosureEdges": self._loop_closure_edges,
                "atlas": self._atlas,
            }
        with open(path, "w") as f:
            json.dump(snapshot, f)
