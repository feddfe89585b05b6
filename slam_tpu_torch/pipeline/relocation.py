"""Relocation against previously-saved atlas maps.

Rebuild of the reference relocation (reference: relocation.cpp:9-61; port of
slam_tpu/pipeline/relocation.py, the RANSAC on ``device``): when a
retrieval hit comes from a read-only atlas map, run the same feature match +
Sim3 RANSAC chain and record the progress stage. Like the reference, this
records LoopStage progress only — no pose fusion is applied (the reference
leaves relocation-based pose correction unimplemented).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from slam_tpu_torch.ids import KfId, MpId
from slam_tpu_torch.map.mapdb import Atlas, LoopStage, MapDB, MapKf
from slam_tpu_torch.ops.ransac import Sim3Ransac
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.pipeline import matcher


def try_relocation(current_kf_id: KfId, candidate: MapKf,
                   current_map_db: MapDB, atlas: Atlas, parameters,
                   settings: StaticSettings, *, device) -> None:
    candidate_map_db = atlas[int(candidate.map_id)]
    current_kf = current_map_db.keyframes[current_kf_id]
    candidate_kf = candidate_map_db.keyframes[candidate.kf_id]

    matched_feature_ids = matcher.match_for_loop_closures(
        current_kf, candidate_kf, current_map_db, candidate_map_db, parameters,
        device=device)

    matches: List[Tuple[MpId, MpId]] = []
    for i, kf_idx2 in enumerate(matched_feature_ids):
        if kf_idx2 >= 0:
            mp1 = int(current_kf.map_points[i])
            mp2 = int(candidate_kf.map_points[kf_idx2])
            if mp1 >= 0 and mp2 >= 0:
                matches.append((MpId(mp1), MpId(mp2)))
    if len(matches) < parameters.minLoopClosureFeatureMatches:
        return
    current_map_db.loop_stages[candidate] = LoopStage.RELOCATION_MAP_POINT_MATCHES

    pts1, pts2, sig1, sig2 = [], [], [], []
    for a, b in matches:
        mp1 = current_map_db.map_points[a]
        mp2 = candidate_map_db.map_points[b]
        pts1.append(current_kf.pose_cw[:3, :3] @ mp1.position
                    + current_kf.pose_cw[:3, 3])
        pts2.append(candidate_kf.pose_cw[:3, :3] @ mp2.position
                    + candidate_kf.pose_cw[:3, 3])
        o1 = int(current_kf.shared.octave[int(mp1.observations[current_kf.id])])
        o2 = int(candidate_kf.shared.octave[int(mp2.observations[candidate_kf.id])])
        sig1.append(float(settings.levelSigmaSq[o1]))
        sig2.append(float(settings.levelSigmaSq[o2]))
    ransac = Sim3Ransac(current_kf.shared.camera, candidate_kf.shared.camera,
                        np.array(pts1), np.array(pts2),
                        np.array(sig1), np.array(sig2), device=device)
    res = ransac.solve(parameters.loopClosureRansacIterations, dof="SIM3",
                       fix_scale=parameters.loopClosureRansacFixScale,
                       min_inliers=parameters.loopClosureRansacMinInliers)
    if not res.ok:
        return
    current_map_db.loop_stages[candidate] = LoopStage.RELOCATION_MAP_POINT_RANSAC
