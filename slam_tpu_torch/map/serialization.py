"""Map persistence and trajectory export.

Rebuild of the reference's cereal-based checkpoint/resume (reference:
serialization.hpp + the serialize() members, mapdb.hpp:83-98,
keyframe.hpp:189-205, map_point.hpp:77-92) using NumPy ``.npz`` archives:
every array field is stored verbatim; retrieval signatures and the
FeatureSearch index are deliberately recomputed on load like the reference
(keyframe.hpp:86-91, mapper_helpers.cpp:974-989).

Also the trajectory CSV export in the IMU frame (reference:
mapper.cpp:514-541).
"""
from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.geometry.camera import Camera
from slam_tpu_torch.ids import KfId, KpId, MapId, MpId, TrackId
from slam_tpu_torch.map.feature_search import FeatureSearch
from slam_tpu_torch.map.keyframe import Keyframe, KeyframeShared
from slam_tpu_torch.map.map_point import MapPoint, MapPointStatus
from slam_tpu_torch.map.mapdb import LoopClosureEdge, MapDB

FORMAT_VERSION = 1


def save_map_db(map_db: MapDB, path: str) -> None:
    arrays = {}
    meta = {
        "version": FORMAT_VERSION,
        "keyframes": [],
        "map_points": [],
        "track_id_to_map_point": {int(k): int(v)
                                  for k, v in map_db.track_id_to_map_point.items()},
        "loop_closure_edges": [
            {"kf_id1": int(e.kf_id1), "kf_id2": int(e.kf_id2)}
            for e in map_db.loop_closure_edges],
        "first_kf_timestamp": map_db.first_kf_timestamp,
        "next_mp": map_db._next_mp,
        "prev_pose_kf_id": int(map_db._prev_pose_kf_id),
        "last_kf_candidate_id": int(map_db._last_kf_candidate_id),
        "last_kf_id": int(map_db._last_kf_id),
    }
    arrays["prev_pose"] = map_db._prev_pose
    arrays["prev_input_pose"] = map_db._prev_input_pose
    arrays["prev_delta"] = map_db._prev_pose_to_prev_keyframe_delta
    arrays["discarded_uncertainty"] = map_db.discarded_uncertainty
    for i, e in enumerate(map_db.loop_closure_edges):
        arrays[f"lce_{i}"] = e.pose_diff

    for kf_id in sorted(map_db.keyframes):
        kf = map_db.keyframes[kf_id]
        tag = f"kf_{int(kf_id)}"
        meta["keyframes"].append({
            "id": int(kf.id),
            "previous_kf_id": int(kf.previous_kf_id),
            "next_kf_id": int(kf.next_kf_id),
            "t": kf.t,
            "has_full_features": kf.has_full_features,
            "camera": kf.shared.camera.serialize(),
            "keypoint_to_track": {int(k): int(v)
                                  for k, v in kf.keypoint_to_track.items()},
        })
        arrays[f"{tag}_pts"] = kf.shared.pts
        arrays[f"{tag}_octave"] = kf.shared.octave
        arrays[f"{tag}_angle"] = kf.shared.angle
        arrays[f"{tag}_desc"] = kf.shared.descriptors
        arrays[f"{tag}_bearings"] = kf.shared.bearings
        arrays[f"{tag}_map_points"] = kf.map_points
        arrays[f"{tag}_depth"] = kf.keypoint_depth
        arrays[f"{tag}_pose_cw"] = kf.pose_cw
        arrays[f"{tag}_orig_pose_cw"] = kf.orig_pose_cw
        arrays[f"{tag}_uncertainty"] = kf.uncertainty
        if kf.shared.colors is not None:
            arrays[f"{tag}_colors"] = kf.shared.colors
        if kf.shared.stereo_point_cloud is not None:
            arrays[f"{tag}_stereo"] = kf.shared.stereo_point_cloud

    for mp_id in sorted(map_db.map_points):
        mp = map_db.map_points[mp_id]
        tag = f"mp_{int(mp_id)}"
        meta["map_points"].append({
            "id": int(mp.id),
            "track_id": int(mp.track_id),
            "status": int(mp.status),
            "min_d": mp.min_viewing_distance,
            "max_d": mp.max_viewing_distance,
            "reference_keyframe": int(mp.reference_keyframe),
            "observations": {int(k): int(v) for k, v in mp.observations.items()},
        })
        arrays[f"{tag}_position"] = mp.position
        arrays[f"{tag}_norm"] = mp.norm
        arrays[f"{tag}_descriptor"] = mp.descriptor
        arrays[f"{tag}_color"] = np.asarray(mp.color)

    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_map_db(map_id: MapId, bow_index, path: str) -> MapDB:
    """Load a map; rebuild retrieval signatures and FeatureSearch like the
    reference's load path (mapper_helpers.cpp:958-993)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    assert meta["version"] == FORMAT_VERSION
    map_db = MapDB()
    map_db._prev_pose = data["prev_pose"]
    map_db._prev_input_pose = data["prev_input_pose"]
    map_db._prev_pose_to_prev_keyframe_delta = data["prev_delta"]
    map_db.discarded_uncertainty = data["discarded_uncertainty"]
    map_db.first_kf_timestamp = meta["first_kf_timestamp"]
    map_db._next_mp = meta["next_mp"]
    map_db._prev_pose_kf_id = KfId(meta["prev_pose_kf_id"])
    map_db._last_kf_candidate_id = KfId(meta["last_kf_candidate_id"])
    map_db._last_kf_id = KfId(meta["last_kf_id"])
    map_db.track_id_to_map_point = {
        TrackId(int(k)): MpId(int(v))
        for k, v in meta["track_id_to_map_point"].items()}
    for i, e in enumerate(meta["loop_closure_edges"]):
        map_db.loop_closure_edges.append(LoopClosureEdge(
            KfId(e["kf_id1"]), KfId(e["kf_id2"]), data[f"lce_{i}"]))

    for kfm in meta["keyframes"]:
        tag = f"kf_{kfm['id']}"
        kf = Keyframe()
        kf.id = KfId(kfm["id"])
        kf.previous_kf_id = KfId(kfm["previous_kf_id"])
        kf.next_kf_id = KfId(kfm["next_kf_id"])
        kf.t = kfm["t"]
        kf.has_full_features = kfm["has_full_features"]
        kf.keypoint_to_track = {KpId(int(k)): TrackId(int(v))
                                for k, v in kfm["keypoint_to_track"].items()}
        kf.map_points = data[f"{tag}_map_points"]
        kf.keypoint_depth = data[f"{tag}_depth"]
        kf.pose_cw = data[f"{tag}_pose_cw"]
        kf.orig_pose_cw = data[f"{tag}_orig_pose_cw"]
        kf.uncertainty = data[f"{tag}_uncertainty"]
        sh = kf.shared
        sh.camera = Camera.deserialize(kfm["camera"])
        sh.pts = data[f"{tag}_pts"]
        sh.octave = data[f"{tag}_octave"]
        sh.angle = data[f"{tag}_angle"]
        sh.descriptors = data[f"{tag}_desc"]
        sh.bearings = data[f"{tag}_bearings"]
        if f"{tag}_colors" in data:
            sh.colors = data[f"{tag}_colors"]
        if f"{tag}_stereo" in data:
            sh.stereo_point_cloud = data[f"{tag}_stereo"]
        # recomputed, not serialized (reference: keyframe.hpp:86-91)
        sh.feature_search = FeatureSearch(sh.pts)
        if bow_index is not None:
            bow_index.transform(sh)
            bow_index.add(kf, map_id)
        map_db.keyframes[kf.id] = kf

    for mpm in meta["map_points"]:
        tag = f"mp_{mpm['id']}"
        mp = MapPoint()
        mp.id = MpId(mpm["id"])
        mp.track_id = TrackId(mpm["track_id"])
        mp.status = MapPointStatus(mpm["status"])
        mp.min_viewing_distance = mpm["min_d"]
        mp.max_viewing_distance = mpm["max_d"]
        mp.reference_keyframe = KfId(mpm["reference_keyframe"])
        mp.observations = {KfId(int(k)): KpId(int(v))
                           for k, v in mpm["observations"].items()}
        mp.position = data[f"{tag}_position"]
        mp.norm = data[f"{tag}_norm"]
        mp.descriptor = data[f"{tag}_descriptor"]
        mp.color = data[f"{tag}_color"]
        map_db.map_points[mp.id] = mp
    return map_db


def save_trajectory_csv(map_db: MapDB, path: str,
                        imu_to_camera: Optional[np.ndarray] = None) -> None:
    """t,x,y,z,qx,qy,qz,qw in the IMU frame (reference: mapper.cpp:514-541)."""
    if imu_to_camera is None:
        imu_to_camera = np.eye(4)
    with open(path, "w") as f:
        for kf_id in sorted(map_db.keyframes):
            kf = map_db.keyframes[kf_id]
            cam_to_world = np.linalg.inv(kf.pose_cw)
            imu_to_world = cam_to_world @ imu_to_camera
            pos = imu_to_world[:3, 3]
            quat = se3.rmat_to_quat(imu_to_world[:3, :3])
            f.write(f"{kf.t:.8f},{pos[0]:.8f},{pos[1]:.8f},{pos[2]:.8f},"
                    f"{quat[0]:.8f},{quat[1]:.8f},{quat[2]:.8f},{quat[3]:.8f}\n")
