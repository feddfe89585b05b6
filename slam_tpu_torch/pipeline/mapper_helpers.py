"""The per-keyframe mapping pipeline.

Rebuild of the reference's pipeline core (reference: mapper_helpers.cpp): the
keyframe decision, track-to-map-point association, local-map matching, new
map-point creation by triangulation, deduplication, culling, consistency
audit, and the ``addKeyframeCommonInner/Outer`` orchestration
(mapper_helpers.cpp:1011-1233).

Host Python drives control flow; every dense numeric step (descriptor
distances, RANSAC, bundle adjustment, retrieval) dispatches to
`slam_tpu_torch/ops` on the device the caller names (a port of
slam_tpu/pipeline/mapper_helpers.py with that device threaded through).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from slam_tpu_torch.geometry import triangulation as tri
from slam_tpu_torch.ids import KfId, KpId, MpId, TrackId, CURRENT_MAP_ID
from slam_tpu_torch.map.keyframe import Keyframe, MapperInput
from slam_tpu_torch.map.map_point import MapPoint, MapPointStatus
from slam_tpu_torch.map.mapdb import (MapDB, MapKf, MapPointRecord,
                                MapPointRecordPosition)
from slam_tpu_torch.ops.hamming import HAMMING_DIST_THR_LOW
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.pipeline import matcher
from slam_tpu_torch.pipeline.adjacency import compute_adjacent_keyframes
from slam_tpu_torch.pipeline.bundle_adjustment import (WorkspaceBA,
                                                collect_pending_ba,
                                                global_bundle_adjust,
                                                local_bundle_adjust,
                                                pose_bundle_adjust)
from slam_tpu_torch.utils.stats import Ba
from slam_tpu_torch.utils.timer import section, timed

CHI2_INV2D = 5.991  # reference: mapper_helpers.cpp:26


def make_keyframe_decision(current_keyframe: Keyframe,
                           previous_keyframe: Optional[Keyframe],
                           current_track_ids: np.ndarray,
                           parameters) -> bool:
    """reference: mapper_helpers.cpp:28-65"""
    if previous_keyframe is None:
        return True
    age = current_keyframe.t - previous_keyframe.t
    assert age >= 0.0
    if age < parameters.keyframeDecisionMinIntervalSeconds:
        return False
    distance = float(np.linalg.norm(current_keyframe.orig_pose_camera_center()
                                    - previous_keyframe.orig_pose_camera_center()))
    if distance > parameters.keyframeDecisionDistanceThreshold:
        return True
    prev_track_ids = set(int(t) for t in previous_keyframe.keypoint_to_track.values())
    assert not current_keyframe.keypoint_to_track or True  # populated later
    n_tracks = len(current_track_ids)
    prev_covis = sum(1 for t in current_track_ids if int(t) in prev_track_ids)
    max_covis = float(n_tracks) * parameters.keyframeDecisionCovisibilityRatio
    return prev_covis <= max_covis


def _match_tracked_features_scalar(current_keyframe: Keyframe, map_db: MapDB,
                                   settings: StaticSettings) -> None:
    """Associate LK tracks with map points; create/triangulate as needed
    (reference: mapper_helpers.cpp:67-142).

    Scalar semantics reference for the batched ``match_tracked_features``;
    the two are kept in lockstep (tests/test_pipeline_e2e.py)."""
    parameters = settings.parameters.slam
    for v in range(current_keyframe.shared.num_keypoints):
        kp_id = KpId(v)
        track_id = current_keyframe.keypoint_to_track.get(kp_id)
        if track_id is None:
            continue
        mp_id = map_db.track_id_to_map_point.get(track_id)
        if mp_id is not None:
            map_point = map_db.map_points[mp_id]
            if map_point.status != MapPointStatus.TRIANGULATED:
                map_point.add_observation(current_keyframe.id, kp_id)
                current_keyframe.add_observation(map_point.id, kp_id)
                triangulate_map_point_first_last_obs(map_db, map_point, settings)
            else:
                if not current_keyframe.is_in_frustum(map_point):
                    continue
                if not check_reprojection_error(
                        map_point.position, current_keyframe, settings, kp_id,
                        parameters.relativeReprojectionErrorThreshold):
                    continue
                map_point.add_observation(current_keyframe.id, kp_id)
                current_keyframe.add_observation(map_point.id, kp_id)
            if map_point.status == MapPointStatus.TRIANGULATED:
                if current_keyframe.has_full_features:
                    map_point.update_descriptor(map_db)
                map_point.update_distance_and_norm(map_db, settings)
        elif current_keyframe.has_full_features:
            # create a fresh map point for this track
            new_id = map_db.next_mp_id()
            map_point = MapPoint(new_id, current_keyframe.id, kp_id)
            current_keyframe.add_observation(map_point.id, kp_id)
            map_db.map_points[new_id] = map_point
            map_point.update_descriptor(map_db)
            map_point.track_id = track_id
            map_point.color = current_keyframe.get_keypoint_color(kp_id)
            map_db.track_id_to_map_point[track_id] = map_point.id


def _batch_update_descriptors(mps: List[MapPoint], map_db: MapDB) -> None:
    """Medoid descriptors for many map points in one native CSR scan — the
    batched twin of ``MapPoint.update_descriptor`` (map_point.cpp:75-116)."""
    from slam_tpu_torch import native
    n = len(mps)
    if n == 0:
        return
    kf_cache: Dict[KfId, Keyframe] = {}
    chunks = []
    dcount = np.zeros(n + 1, np.int64)
    for i, mp in enumerate(mps):
        for kf_id in sorted(mp.observations):
            kf = kf_cache.get(kf_id)
            if kf is None:
                kf = kf_cache[kf_id] = map_db.keyframes[kf_id]
            if kf.has_full_features:
                chunks.append(kf.shared.descriptors[int(mp.observations[kf_id])])
                dcount[i + 1] += 1
    if not chunks:
        return
    dptr = np.cumsum(dcount)
    flat = np.stack(chunks)
    med = native.medoid_descriptor_many(flat, dptr)
    for i, mp in enumerate(mps):
        if med[i] >= 0:
            mp.descriptor = flat[dptr[i] + med[i]].copy()


def _batch_update_cones(mps: List[MapPoint], map_db: MapDB,
                        settings: StaticSettings) -> None:
    """Viewing normal + min/max distance for many map points in one
    vectorized pass — the batched twin of
    ``MapPoint.update_distance_and_norm`` (map_point.cpp:158-172)."""
    n = len(mps)
    if n == 0:
        return
    kf_row: Dict[KfId, int] = {}
    centers_list: List[np.ndarray] = []
    kfs_list: List[Keyframe] = []
    seg, crow = [], []
    positions = np.empty((n, 3))
    first_crow = np.empty(n, np.int64)
    first_oct = np.empty(n, np.int64)
    for i, mp in enumerate(mps):
        positions[i] = mp.position
        obs_sorted = sorted(mp.observations)
        for kf_id in obs_sorted:
            r = kf_row.get(kf_id)
            if r is None:
                kf = map_db.keyframes[kf_id]
                r = kf_row[kf_id] = len(centers_list)
                centers_list.append(kf.camera_center())
                kfs_list.append(kf)
            seg.append(i)
            crow.append(r)
        r0 = kf_row[obs_sorted[0]]
        first_crow[i] = r0
        first_oct[i] = int(
            kfs_list[r0].shared.octave[int(mp.observations[obs_sorted[0]])])
    centers = np.asarray(centers_list)
    seg_a = np.asarray(seg, np.int64)
    crow_a = np.asarray(crow, np.int64)
    v = centers[crow_a] - positions[seg_a]
    vnorm = np.linalg.norm(v, axis=1)
    vunit = np.zeros_like(v)
    nz = vnorm > 0
    vunit[nz] = v[nz] / vnorm[nz, None]
    norm_sum = np.zeros((n, 3))
    np.add.at(norm_sum, seg_a, vunit)
    counts = np.bincount(seg_a, minlength=n)
    norms = (norm_sum / counts[:, None]).astype(np.float32)
    dist0 = np.linalg.norm(centers[first_crow] - positions, axis=1)
    sf = np.asarray(settings.scaleFactors, np.float64)
    max_d = dist0 * sf[first_oct]
    min_d = max_d / float(sf[-1])
    for i, mp in enumerate(mps):
        mp.norm = norms[i].copy()
        mp.max_viewing_distance = float(max_d[i])
        mp.min_viewing_distance = float(min_d[i])


def _mtf_chi2_counts(positions: np.ndarray, mps: List[MapPoint],
                     map_db: MapDB, settings: StaticSettings) -> np.ndarray:
    """Octave-scaled chi2 reprojection votes over ALL observations of each
    map point, grouped per keyframe — the batched twin of the
    ``check_reprojection_error`` tally in
    ``triangulate_map_point_first_last_obs`` (mapper_helpers.cpp:784-795).

    positions: (n,3) candidate world positions. Returns n_ok (n,) int."""
    rel_thr = settings.parameters.slam.relativeReprojectionErrorThreshold
    ref_scale = len(settings.scaleFactors) // 2
    sigma_sq = np.asarray(settings.levelSigmaSq, np.float64)
    n = len(mps)
    by_kf: Dict[KfId, Tuple[List[int], List[int]]] = {}
    for i, mp in enumerate(mps):
        for kf_id, kp_id in mp.observations.items():
            slot = by_kf.get(kf_id)
            if slot is None:
                slot = by_kf[kf_id] = ([], [])
            slot[0].append(i)
            slot[1].append(int(kp_id))
    n_ok = np.zeros(n, np.int64)
    for kf_id, (seg, kps) in by_kf.items():
        kf = map_db.keyframes[kf_id]
        seg_a = np.asarray(seg, np.int64)
        kps_a = np.asarray(kps, np.int64)
        pix, ok = kf.reproject_many(positions[seg_a])
        pts = kf.shared.pts[kps_a]
        rel_base = get_focal_length(kf) * rel_thr
        sigma2 = (sigma_sq[kf.shared.octave[kps_a]] / sigma_sq[ref_scale]
                  * rel_base * rel_base)
        err = np.sum((pix - pts) ** 2, axis=1)
        np.add.at(n_ok, seg_a, (ok & (err <= CHI2_INV2D * sigma2)).astype(np.int64))
    return n_ok


def _mtf_pending(current_keyframe: Keyframe, mps: List[MapPoint],
                 kps: np.ndarray, map_db: MapDB,
                 settings: StaticSettings) -> List[MapPoint]:
    """Batched ``triangulate_map_point_first_last_obs`` over the tracked
    keypoints whose map point is not yet TRIANGULATED
    (reference: mapper_helpers.cpp:724-812). Observations (incl. the current
    keyframe) are already registered. Returns the chi2-passing points whose
    descriptor the scalar path would refresh."""
    parameters = settings.parameters.slam
    n = len(mps)
    for mp in mps:
        mp.status = MapPointStatus.NOT_TRIANGULATED
    kf_map = map_db.keyframes[current_keyframe.id]

    # batch-eligible: >=2 observations and the current keyframe is the last
    # (max-id) observation — always true on the pipeline path; anything else
    # falls back to the scalar twin
    batch = np.ones(n, bool)
    fallback_passed: List[MapPoint] = []
    for i, mp in enumerate(mps):
        if len(mp.observations) < 2 or mp.get_last_observation() != kf_map.id:
            batch[i] = False
            if len(mp.observations) >= 2:
                triangulate_map_point_first_last_obs(map_db, mp, settings)
                if mp.status != MapPointStatus.NOT_TRIANGULATED:
                    fallback_passed.append(mp)
    idx = np.flatnonzero(batch)
    if len(idx) == 0:
        return fallback_passed
    mps_b = [mps[i] for i in idx]
    kps_b = np.asarray(kps, np.int64)[idx]
    nb = len(idx)

    depth = kf_map.keypoint_depth[kps_b].astype(np.float64)
    seeded = depth > 0
    positions = np.zeros((nb, 3))
    have_pos = np.zeros(nb, bool)
    R_wc = kf_map.camera_to_world_rotation()
    c_cur = kf_map.camera_center()
    if np.any(seeded):
        s = np.flatnonzero(seeded)
        positions[s] = (depth[s, None]
                        * (kf_map.shared.bearings[kps_b[s]] @ R_wc.T) + c_cur)
        have_pos[seeded] = True

    todo = np.flatnonzero(~seeded)
    if len(todo) and not parameters.computeDenseStereoDepth:
        # two-view DLT against the FIRST observation, grouped by first kf
        first_ids = np.asarray([int(mps_b[i].get_first_observation())
                                for i in todo], np.int64)
        first_kps = np.asarray(
            [int(mps_b[i].observations[KfId(f)])
             for i, f in zip(todo, first_ids)], np.int64)
        rays2 = kf_map.shared.bearings[kps_b[todo]] @ R_wc.T
        rays2 /= np.maximum(np.linalg.norm(rays2, axis=1, keepdims=True), 1e-12)
        npix2_all, nok2_all = kf_map.shared.normalized_pixels()
        npix2 = npix2_all[kps_b[todo]]
        nok2 = nok2_all[kps_b[todo]].astype(bool)
        P2 = kf_map.pose_cw[:3]
        cos_min = np.cos(np.radians(parameters.minTriangulationAngleTwoObs))
        for f in np.unique(first_ids):
            g = todo[first_ids == f]
            gk = first_kps[first_ids == f]
            fkf = map_db.keyframes[KfId(int(f))]
            rays1 = fkf.shared.bearings[gk] @ fkf.camera_to_world_rotation().T
            rays1 /= np.maximum(np.linalg.norm(rays1, axis=1, keepdims=True),
                                1e-12)
            sel = np.flatnonzero(first_ids == f)
            angle_ok = np.sum(rays1 * rays2[sel], axis=1) < cos_min
            npix1_all, nok1_all = fkf.shared.normalized_pixels()
            x1 = npix1_all[gk]
            pair_ok = angle_ok & nok1_all[gk].astype(bool) & nok2[sel]
            if not np.any(pair_ok):
                continue
            p = np.flatnonzero(pair_ok)
            P1 = fkf.pose_cw[:3]
            x2 = npix2[sel[p]]
            m = len(p)
            A = np.empty((m, 4, 4))
            A[:, 0] = x1[p, 0, None] * P1[2] - P1[0]
            A[:, 1] = x1[p, 1, None] * P1[2] - P1[1]
            A[:, 2] = x2[:, 0, None] * P2[2] - P2[0]
            A[:, 3] = x2[:, 1, None] * P2[2] - P2[1]
            _, _, vt = np.linalg.svd(A)
            Xh = vt[:, -1, :]
            w_ok = np.abs(Xh[:, 3]) >= 1e-12
            rows = g[p[w_ok]]
            positions[rows] = (Xh[w_ok, :3]
                               / Xh[w_ok, 3, None])
            have_pos[rows] = True

    cand = np.flatnonzero(have_pos)
    if len(cand) == 0:
        return fallback_passed
    # position is written BEFORE the chi2 vote, like the scalar path
    for i in cand.tolist():
        mps_b[i].position = positions[i].copy()
    cand_mps = [mps_b[i] for i in cand]
    n_ok = _mtf_chi2_counts(positions[cand], cand_mps, map_db, settings)
    passed = fallback_passed
    for j, mp in enumerate(cand_mps):
        if n_ok[j] >= 2:
            mp.status = (MapPointStatus.TRIANGULATED
                         if len(mp.observations) > 2
                         else MapPointStatus.UNSURE)
            passed.append(mp)
    return passed


@timed
def match_tracked_features(current_keyframe: Keyframe, map_db: MapDB,
                           settings: StaticSettings) -> None:
    """Associate LK tracks with map points; create/triangulate as needed
    (reference: mapper_helpers.cpp:67-142).

    Batched implementation of ``_match_tracked_features_scalar`` (the
    semantics reference, cross-checked in tests/test_pipeline_e2e.py):
    tracked keypoints partition into
      - fresh tracks -> new NOT_TRIANGULATED points (vectorized colors),
      - tracks on a not-yet-TRIANGULATED point -> one batched first+last
        triangulation (depth seeding, grouped two-view DLT, chi2 vote),
      - tracks on a TRIANGULATED point -> vectorized frustum / viewing-cone /
        chi2 acceptance,
    and the surviving points take ONE batched medoid-descriptor and
    viewing-cone refresh instead of per-point update calls."""
    parameters = settings.parameters.slam
    kf = current_keyframe
    if not kf.keypoint_to_track:
        return
    items = sorted(kf.keypoint_to_track.items())
    t2mp = map_db.track_id_to_map_point
    mpd = map_db.map_points
    pend_mps: List[MapPoint] = []
    pend_kps: List[int] = []
    tri_mps: List[MapPoint] = []
    tri_kps: List[int] = []
    fresh_kps: List[int] = []
    fresh_tids: List[TrackId] = []
    for kp_id, track_id in items:
        mp_id = t2mp.get(track_id)
        if mp_id is not None:
            mp = mpd[mp_id]
            if mp.status != MapPointStatus.TRIANGULATED:
                mp.add_observation(kf.id, kp_id)
                kf.add_observation(mp.id, kp_id)
                pend_mps.append(mp)
                pend_kps.append(int(kp_id))
            else:
                tri_mps.append(mp)
                tri_kps.append(int(kp_id))
        elif kf.has_full_features:
            fresh_kps.append(int(kp_id))
            fresh_tids.append(track_id)

    desc_batch: List[MapPoint] = []
    cone_batch: List[MapPoint] = []

    if pend_mps:
        passed = _mtf_pending(kf, pend_mps, np.asarray(pend_kps, np.int64),
                              map_db, settings)
        desc_batch.extend(passed)
        cone_batch.extend(mp for mp in passed
                          if mp.status == MapPointStatus.TRIANGULATED)

    if tri_mps:
        # frustum + viewing-cone + chi2 acceptance for already-triangulated
        # points (keyframe.cpp:247-262 + mapper_helpers.cpp:576-598 gates)
        kps_a = np.asarray(tri_kps, np.int64)
        store = map_db.mp_store
        rows = np.fromiter((mp._row for mp in tri_mps), np.int64,
                           count=len(tri_mps))
        positions = store.position[rows]
        pix, visible = kf.reproject_many(positions)
        mp_to_kf = (kf.camera_center() - positions).astype(np.float32)
        dist = np.linalg.norm(mp_to_kf, axis=1)
        norms_arr = store.norm[rows]
        min_d = store.min_viewing_distance[rows]
        max_d = store.max_viewing_distance[rows]
        dots = np.sum(mp_to_kf * norms_arr, axis=1)
        viewing_cos = np.where(dist > 0, dots / np.maximum(dist, 1e-30), 1.0)
        frustum = (visible & (dist >= min_d) & (dist <= max_d)
                   & (viewing_cos >= 0.5))
        rel_base = (get_focal_length(kf)
                    * parameters.relativeReprojectionErrorThreshold)
        ref_scale = len(settings.scaleFactors) // 2
        sigma_sq = np.asarray(settings.levelSigmaSq, np.float64)
        sigma2 = (sigma_sq[kf.shared.octave[kps_a]] / sigma_sq[ref_scale]
                  * rel_base * rel_base)
        err = np.sum((pix - kf.shared.pts[kps_a]) ** 2, axis=1)
        accept = frustum & (err <= CHI2_INV2D * sigma2)
        for i in np.flatnonzero(accept).tolist():
            mp = tri_mps[i]
            mp.add_observation(kf.id, KpId(tri_kps[i]))
            kf.add_observation(mp.id, KpId(tri_kps[i]))
            if kf.has_full_features:
                desc_batch.append(mp)
            cone_batch.append(mp)

    if fresh_kps:
        # fresh tracks: one new NOT_TRIANGULATED point per track
        # (mapper_helpers.cpp:127-141); n=1 medoid == own descriptor
        kps_a = np.asarray(fresh_kps, np.int64)
        if kf.shared.colors is not None:
            colors = kf.shared.colors[kps_a]
        else:
            colors = np.zeros((len(kps_a), 3), np.uint8)
        descs = kf.shared.descriptors[kps_a]
        for j, (kp, tid) in enumerate(zip(fresh_kps, fresh_tids)):
            new_id = map_db.next_mp_id()
            mp = MapPoint(new_id, kf.id, KpId(kp))
            kf.add_observation(mp.id, KpId(kp))
            mpd[new_id] = mp
            mp.descriptor = descs[j].copy()
            mp.track_id = tid
            mp.color = colors[j]
            t2mp[tid] = mp.id

    _batch_update_descriptors(desc_batch, map_db)
    _batch_update_cones(cone_batch, map_db, settings)


@timed
def match_local_map_points(current_keyframe: Keyframe,
                           adjacent_kf_ids: List[KfId], map_db: MapDB,
                           settings: StaticSettings,
                           viewer_publisher=None, *, device) -> None:
    """reference: mapper_helpers.cpp:231-269 (frustum test vectorized)"""
    parameters = settings.parameters.slam
    if not adjacent_kf_ids:
        return
    # unique candidate ids over the adjacent keyframes, minus the ones the
    # current keyframe already observes (kf-side membership, the audited link
    # invariant for "current_keyframe.id in mp.observations")
    allv = np.concatenate([map_db.keyframes[k].map_points
                           for k in adjacent_kf_ids])
    uniq = np.unique(allv[allv >= 0])
    cur_vals = current_keyframe.map_points
    uniq = uniq[~np.isin(uniq, cur_vals[cur_vals >= 0])]
    # single pass: status gate + batched-isInFrustum column fill
    # (keyframe.cpp:247-262 semantics), via the columnar store
    store = map_db.mp_store
    rows, live = store.rows_of(uniq)
    st = store.status[rows]
    keep = (live & (st != int(MapPointStatus.NOT_TRIANGULATED))
            & (st != int(MapPointStatus.BAD)))
    rows = rows[keep]
    if len(rows) == 0:
        return
    candidates = [store.objs[r] for r in rows.tolist()]
    positions = store.position[rows]
    norms = store.norm[rows]
    min_d = store.min_viewing_distance[rows]
    max_d = store.max_viewing_distance[rows]
    pix, visible = current_keyframe.reproject_many(positions)
    mp_to_kf = (current_keyframe.camera_center() - positions).astype(np.float32)
    dist = np.linalg.norm(mp_to_kf, axis=1)
    viewing_cos = np.sum(mp_to_kf * norms, axis=1) / np.maximum(dist, 1e-12)
    ok = visible & (dist >= min_d) & (dist <= max_d) & (viewing_cos >= 0.5)
    sel = np.flatnonzero(ok)
    if len(sel) == 0:
        return
    local = [candidates[k] for k in sel]
    r = get_focal_length(current_keyframe) * parameters.relativeReprojectionErrorThreshold
    # hand the already-computed gate columns over (identical formulas), so
    # search_by_projection skips its own gather + reprojection pass
    matcher.search_by_projection(
        current_keyframe, [mp.id for mp in local], map_db, r, settings,
        precomp=(local, pix[sel], visible[sel], dist[sel], viewing_cos[sel],
                 min_d[sel], max_d[sel], store.descriptor[rows[sel]]),
        data_publisher=viewer_publisher, device=device)


def _batch_triangulate_pairs(cur_kf: Keyframe, pair_list,
                             settings: StaticSettings):
    """Vectorized two-observation triangulation for fresh map points, batched
    over EVERY adjacent keyframe of one ``createNewMapPoints`` pass.

    Batched equivalent of ``triangulateMapPoint`` for the 2-observation case
    created by ``createNewMapPoints`` (mapper_helpers.cpp:600-722 with
    observations {adjacent kf, current kf}): depth seeding from the first
    positive-depth observation in KfId order, the two-ray angle gate,
    two-view DLT, and positive-depth + reprojection gates on both frames.

    ``pair_list``: list of (adj_kf, matches (B_i, 2)) — one entry per
    adjacent keyframe, matches columns are (cur keypoint, adj keypoint).
    Returns (positions (B, 3), ok (B,)) concatenated in pair_list order
    (one SVD batch + one gate pass instead of one per adjacent keyframe).
    """
    parameters = settings.parameters.slam
    B = sum(len(m) for _, m in pair_list)
    kp_cur = np.empty(B, np.int64)
    kp_adj = np.empty(B, np.int64)
    d_adj = np.empty(B)
    rays_adj = np.empty((B, 3))
    rays_cur = np.empty((B, 3))
    c_adj = np.empty((B, 3))
    n_adj = np.empty((B, 2))
    ok_a = np.empty(B, bool)
    P1 = np.empty((B, 3, 4))
    oct_adj = np.empty(B, np.int64)
    pts_adj = np.empty((B, 2))

    R_cur = cur_kf.camera_to_world_rotation()
    c_cur = cur_kf.camera_center()
    o = 0
    for adj_kf, matches in pair_list:
        # KfId order: the adjacent keyframe is always older than the current
        assert adj_kf.id < cur_kf.id
        m = np.asarray(matches, np.int64).reshape(-1, 2)
        s = slice(o, o + len(m))
        o += len(m)
        kp_cur[s] = m[:, 0]
        kp_adj[s] = m[:, 1]
        d_adj[s] = adj_kf.keypoint_depth[m[:, 1]]
        R_adj = adj_kf.camera_to_world_rotation()
        rays_adj[s] = adj_kf.shared.bearings[m[:, 1]] @ R_adj.T
        c_adj[s] = adj_kf.camera_center()
        npx, oka = adj_kf.shared.camera.normalize_pixel(
            adj_kf.shared.pts[m[:, 1]])
        n_adj[s] = npx
        ok_a[s] = oka
        P1[s] = adj_kf.pose_cw[:3]
        oct_adj[s] = adj_kf.shared.octave[m[:, 1]]
        pts_adj[s] = adj_kf.shared.pts[m[:, 1]]
    d_cur = cur_kf.keypoint_depth[kp_cur]
    rays_cur[:] = cur_kf.shared.bearings[kp_cur] @ R_cur.T

    positions = np.zeros((B, 3))
    ok = np.zeros(B, bool)

    # depth seeding: first positive depth in observation order (adj, cur)
    seed_adj = d_adj > 0
    seed_cur = (~seed_adj) & (d_cur > 0)
    positions[seed_adj] = (d_adj[seed_adj, None] * rays_adj[seed_adj]
                           + c_adj[seed_adj])
    positions[seed_cur] = (d_cur[seed_cur, None] * rays_cur[seed_cur] + c_cur)
    seeded = seed_adj | seed_cur

    # DLT path with the two-ray angle gate
    dlt = ~seeded
    if dlt.any():
        cos_min = np.cos(np.radians(parameters.minTriangulationAngleTwoObs))
        u1 = rays_adj[dlt] / np.maximum(
            np.linalg.norm(rays_adj[dlt], axis=1, keepdims=True), 1e-12)
        u2 = rays_cur[dlt] / np.maximum(
            np.linalg.norm(rays_cur[dlt], axis=1, keepdims=True), 1e-12)
        angle_ok = np.sum(u1 * u2, axis=1) < cos_min
        n1 = n_adj[dlt]
        n_cur, ok_c = cur_kf.shared.camera.normalize_pixel(
            cur_kf.shared.pts[kp_cur[dlt]])
        P1d = P1[dlt]
        P2 = cur_kf.pose_cw[:3]
        A = np.stack([
            n1[:, 0, None] * P1d[:, 2] - P1d[:, 0],
            n1[:, 1, None] * P1d[:, 2] - P1d[:, 1],
            n_cur[:, 0, None] * P2[2][None] - P2[0][None],
            n_cur[:, 1, None] * P2[2][None] - P2[1][None],
        ], axis=1)  # (b, 4, 4)
        _, _, vt = np.linalg.svd(A)
        Xh = vt[:, -1, :]
        w = Xh[:, 3]
        nonzero = np.abs(w) > 1e-12
        X = np.zeros((len(Xh), 3))
        X[nonzero] = Xh[nonzero, :3] / w[nonzero, None]
        idx = np.where(dlt)[0]
        positions[idx] = X
        ok[idx] = angle_ok & ok_a[dlt] & ok_c & nonzero
    ok[seeded] = True

    # gates on both frames: positive depth + octave-scaled reprojection chi2.
    # Adjacent-side rows carry per-row poses/octaves; the current keyframe is
    # shared by every row.
    ref_scale = len(settings.scaleFactors) // 2
    rel_thr = parameters.relativeReprojectionErrorThreshold

    # adjacent frames: per-row poses fused into one projection batch, camera
    # model applied per keyframe group (sessions share one camera, but the
    # model object is per keyframe)
    z = np.sum(P1[:, 2, :3] * positions, axis=1) + P1[:, 2, 3]
    pc = (P1[:, :, :3] @ positions[:, :, None])[:, :, 0] + P1[:, :, 3]
    o = 0
    for adj_kf, matches in pair_list:
        s = slice(o, o + len(matches))
        o += len(matches)
        cam = adj_kf.shared.camera
        pix, vis = cam.ray_to_pixel(pc[s])
        vis = vis & cam.is_valid_pixel(pix)
        rel = cam.get_focal_length() * rel_thr
        sigma2 = (settings.levelSigmaSq[oct_adj[s]]
                  / settings.levelSigmaSq[ref_scale] * rel * rel)
        err = np.sum((pix - pts_adj[s]) ** 2, axis=1)
        ok[s] &= (z[s] > 0) & vis & (err <= CHI2_INV2D * sigma2)

    # current frame
    kf = cur_kf
    z = positions @ kf.pose_cw[2, :3] + kf.pose_cw[2, 3]
    pix, vis = kf.reproject_many(positions)
    rel = get_focal_length(kf) * rel_thr
    sigma2 = (settings.levelSigmaSq[kf.shared.octave[kp_cur]]
              / settings.levelSigmaSq[ref_scale] * rel * rel)
    err = np.sum((pix - kf.shared.pts[kp_cur]) ** 2, axis=1)
    ok &= (z > 0) & vis & (err <= CHI2_INV2D * sigma2)
    return positions, ok


def _tri_frame(kf: Keyframe, cam_pack):
    """One keyframe's array block for ``native.triangulate_pairs``."""
    npix, nok = kf.shared.normalized_pixels()
    return (np.ascontiguousarray(kf.pose_cw[:3], np.float64),
            kf.shared.bearings, kf.keypoint_depth, npix, nok,
            kf.shared.pts, kf.shared.octave, cam_pack)


@timed
def create_new_map_points(current_keyframe: Keyframe,
                          adjacent_kf_ids: List[KfId], map_db: MapDB,
                          settings: StaticSettings, *, device) -> None:
    """reference: mapper_helpers.cpp:271-318

    The per-adjacent-keyframe match -> create order is load-bearing: a match
    triangulated OK claims its current-keyframe keypoint, which must be
    excluded (``free1``) from the NEXT adjacent keyframe's matcher call, so
    the loop stays sequential; within one pair every triangulation solve and
    gate runs in ONE fused native pass (NumPy twin:
    ``_batch_triangulate_pairs``, kept in lockstep by the cross-check test in
    tests/test_native_and_misc.py)."""
    from slam_tpu_torch import native

    cur_full = current_keyframe.has_full_features
    parameters = settings.parameters.slam
    cos_min = np.cos(np.radians(parameters.minTriangulationAngleTwoObs))
    ref_scale = len(settings.scaleFactors) // 2
    sigma2_rel = (np.asarray(settings.levelSigmaSq, np.float64)
                  / settings.levelSigmaSq[ref_scale])
    cam_pack_cur = native.pack_camera(current_keyframe.shared.camera)
    cur_frame = None
    sf64 = np.ascontiguousarray(settings.scaleFactors, np.float64)
    epi_deg = parameters.epipolarCheckThresholdDegrees
    cur_sh = current_keyframe.shared
    for kf_id in adjacent_kf_ids:
        if kf_id == current_keyframe.id:
            continue
        keyframe = map_db.keyframes[kf_id]
        assert keyframe.id < current_keyframe.id  # KfId depth-seeding order
        if cur_frame is None:
            cur_frame = _tri_frame(current_keyframe, cam_pack_cur)
        # fused native pair stage: matching + rotation vote + gated
        # triangulation in one call (the per-pair NumPy glue costs more
        # than the matching at ~10 adjacent keyframes per backend frame)
        adj_sh = keyframe.shared
        fused = None
        if cur_sh.num_keypoints and adj_sh.num_keypoints:
            adj_frame = _tri_frame(keyframe,
                                   native.pack_camera(adj_sh.camera))
            fused = native.match_triangulate_pair(
                (cur_sh.descriptors, cur_sh.groups,
                 (current_keyframe.map_points < 0).astype(np.uint8),
                 cur_sh.bearings, cur_sh.angle, cur_sh.octave),
                (adj_sh.descriptors, adj_sh.groups,
                 (keyframe.map_points < 0).astype(np.uint8),
                 adj_sh.bearings, adj_sh.angle),
                cur_frame[0], adj_frame[0], sf64, epi_deg,
                HAMMING_DIST_THR_LOW, cur_frame, adj_frame,
                cos_min, sigma2_rel,
                parameters.relativeReprojectionErrorThreshold, CHI2_INV2D)
        if fused is not None:
            kpc, kpa, positions, ok = fused
            if len(kpc) == 0:
                continue
            matches = np.stack([kpc, kpa], axis=1)
        else:
            matches = matcher.match_for_triangulation(
                current_keyframe, keyframe, settings, device=device)
            if len(matches) == 0:
                continue
            res = native.triangulate_pairs(
                matches[:, 0], matches[:, 1], cur_frame,
                _tri_frame(keyframe,
                           native.pack_camera(keyframe.shared.camera)),
                cos_min, sigma2_rel,
                parameters.relativeReprojectionErrorThreshold, CHI2_INV2D)
            if res is not None:
                positions, ok = res
            else:
                positions, ok = _batch_triangulate_pairs(
                    current_keyframe, [(keyframe, matches)], settings)
        # update_descriptor on a fresh 2-observation point always resolves to
        # the first full-featured observation's descriptor (obs sorted by
        # KfId: the adjacent keyframe is older); inline that medoid shortcut
        adj_full = keyframe.has_full_features
        for row, (kp_cur, kp_adj) in enumerate(matches.tolist()):
            # the reference allocates the id and creates the MapPoint before
            # the triangulation check, registering it only on success
            # (mapper_helpers.cpp:302-316) — keep the id sequence identical
            mp_id = map_db.next_mp_id()
            if not ok[row]:
                continue
            kp_cur, kp_adj = KpId(kp_cur), KpId(kp_adj)
            map_point = MapPoint(mp_id, keyframe.id, kp_adj)
            map_point.color = keyframe.get_keypoint_color(kp_adj)
            map_point.add_observation(current_keyframe.id, kp_cur)
            map_point.position = positions[row].copy()
            map_point.status = MapPointStatus.UNSURE
            current_keyframe.add_observation(map_point.id, kp_cur)
            keyframe.add_observation(map_point.id, kp_adj)
            map_db.map_points[mp_id] = map_point
            if adj_full:
                map_point.descriptor = keyframe.shared.descriptors[int(kp_adj)].copy()
            elif cur_full:
                map_point.descriptor = current_keyframe.shared.descriptors[int(kp_cur)].copy()


@timed
def deduplicate_map_points(current_keyframe: Keyframe,
                           adjacent_kf_ids: List[KfId], map_db: MapDB,
                           settings: StaticSettings) -> None:
    """reference: mapper_helpers.cpp:320-347"""
    if not adjacent_kf_ids:
        return
    margin = (get_focal_length(current_keyframe)
              * settings.parameters.slam.relativeReprojectionErrorThreshold)
    # attribute columns are loop-invariant within the pass (merges only
    # rewire observation links) and every candidate id any call can see —
    # including ids merges write into keyframe slots — lies in the union of
    # the current + adjacent keyframes' slots, so the columns are built ONCE
    # over that union and every per-call lookup is a vectorized gather
    cur_sel = current_keyframe.map_points[current_keyframe.map_points >= 0]
    allv = np.concatenate([map_db.keyframes[k].map_points
                           for k in adjacent_kf_ids])
    adjacent_vals = np.unique(allv[allv >= 0])  # sorted unique ids
    cache = matcher._MpColumnCache(map_db)
    cache.prime(np.union1d(cur_sel, adjacent_vals))
    prev_key = None
    mp_ids: List[MpId] = []
    for kf_id in adjacent_kf_ids:
        adjacent = map_db.keyframes[kf_id]
        # the candidate list is re-derived per adjacent keyframe (a merge may
        # rewrite the current keyframe's slots, reference semantics), but the
        # id objects are only rebuilt when the slots actually changed
        sel = current_keyframe.map_points[current_keyframe.map_points >= 0]
        key = sel.tobytes()
        if key != prev_key:
            prev_key = key
            mp_ids = [MpId(int(v)) for v in sel]
        matcher.replace_duplication(adjacent, mp_ids, margin, map_db, settings,
                                    cache=cache, cache_key=key)
    # re-derive the reverse-pass candidates AFTER the merge loop (a merge can
    # write a current-keyframe id into an adjacent slot); every such id is
    # still inside the primed union
    allv = np.concatenate([map_db.keyframes[k].map_points
                           for k in adjacent_kf_ids])
    adjacent_vals = np.unique(allv[allv >= 0])
    matcher.replace_duplication(
        current_keyframe, [MpId(int(v)) for v in adjacent_vals], margin,
        map_db, settings, cache=cache)


@timed
def cull_map_points(current_keyframe: Keyframe, map_db: MapDB,
                    parameters) -> None:
    """reference: mapper_helpers.cpp:349-373

    Vectorized over the columnar store: the whole-map scan reduces to column
    compares (observation count, first-observation age, status, membership in
    the current keyframe — the audited bidirectional-link invariant), and
    only actual removals touch Python objects. Removing a map point never
    changes another's gate columns, so the batch decision equals the
    reference's sequential scan."""
    store = map_db.mp_store
    ids = np.flatnonzero(store.id2row >= 0)
    if len(ids) == 0:
        return
    rows = store.id2row[ids]
    n_obs = store.n_obs[rows]
    status = store.status[rows]
    first_kf = store.first_kf[rows]
    cur_vals = current_keyframe.map_points
    observed = np.isin(ids, cur_vals[cur_vals >= 0])
    cand = (~observed) & (status != int(MapPointStatus.TRIANGULATED)) & (n_obs > 0)
    if cand.any():
        # gather creation times via unique+inverse over the candidate rows
        # only (same lookup set as before): the previous per-unique
        # boolean-mask loop was O(U x N) and super-linear in map size
        uniq, inv = np.unique(first_kf[cand], return_inverse=True)
        t_of = np.array([map_db.keyframes[KfId(int(v))].t for v in uniq])
        old_enough = ((current_keyframe.t - t_of[inv])
                      > parameters.minMapPointCullingAge)
        cand_idx = np.flatnonzero(cand)
        cand[cand_idx[~old_enough]] = False
    remove = cand | (n_obs == 0)
    for v in ids[remove].tolist():
        map_db.remove_map_point(map_db.map_points[MpId(v)])


def remove_keyframe(kf_id: KfId, map_db: MapDB, bow_index=None) -> None:
    """reference: mapper_helpers.cpp:375-431"""
    keyframe = map_db.keyframes[kf_id]
    for edge in map_db.loop_closure_edges:
        assert kf_id != edge.kf_id1 and kf_id != edge.kf_id2
    if bow_index is not None:
        bow_index.remove(MapKf(CURRENT_MAP_ID, kf_id))

    prev = keyframe.previous_kf_id
    nxt = keyframe.next_kf_id
    assert prev.valid, "Cannot delete first keyframe"

    to_erase = set()
    for mp_val in keyframe.map_points:
        if mp_val < 0:
            continue
        mp = map_db.map_points[MpId(int(mp_val))]
        mp.erase_observation(keyframe.id)
        if not mp.observations:
            to_erase.add(mp.id)
    for mp_id in sorted(to_erase):
        map_db.remove_map_point(map_db.map_points[mp_id])

    if nxt.valid:
        next_kf = map_db.keyframes[nxt]
        next_kf.uncertainty = next_kf.uncertainty + keyframe.uncertainty
        next_kf.previous_kf_id = prev
    if prev.valid:
        map_db.keyframes[prev].next_kf_id = nxt
    for mp in map_db.map_points.values():
        if mp.reference_keyframe == keyframe.id:
            mp.reference_keyframe = prev
    # every observation of this keyframe was erased above, so its pair
    # counts must all have drained — drop the empty covis slot
    leftover = map_db.mp_store.covis.pop(kf_id, None)
    assert not leftover, f"covis leftover for removed keyframe {kf_id}"
    del map_db.keyframes[kf_id]


@timed
def cull_keyframes(adjacent_kf_ids: List[KfId], map_db: MapDB, bow_index,
                   parameters) -> None:
    """reference: mapper_helpers.cpp:433-482"""
    current_kf_id = max(map_db.keyframes)
    for kf_id in sorted(adjacent_kf_ids, reverse=True):
        assert kf_id != current_kf_id
        kf = map_db.keyframes.get(kf_id)
        if kf is None:
            continue
        if not kf.previous_kf_id.valid:
            continue
        if any(kf_id in (e.kf_id1, e.kf_id2) for e in map_db.loop_closure_edges):
            continue
        # observation counts from the columnar store (recomputed per
        # candidate: an earlier removal in this loop changes them)
        vals = kf.map_points[kf.map_points >= 0]
        rows, _ = map_db.mp_store.rows_of(vals)
        n_map_points = len(vals)
        n_critical = int(np.sum(map_db.mp_store.n_obs[rows]
                                <= parameters.minObservationsForBA))
        if n_critical < n_map_points * parameters.keyframeCullMaxCriticalRatio:
            remove_keyframe(kf.id, map_db, bow_index)


def check_consistency(map_db: MapDB) -> None:
    """Bidirectional link + chain audit (reference: mapper_helpers.cpp:499-549),
    extended with the columnar-store coherence audit (map/mp_store.py: every
    mirrored column must equal the object attribute it shadows).

    Raises AssertionError on violation; used by tests after every episode and
    by the mapper at end()."""
    store = map_db.mp_store
    for mp_id, mp in map_db.map_points.items():
        row = mp._row
        assert mp._store is store and row >= 0
        assert store.id2row[int(mp_id)] == row
        assert store.objs[row] is mp
        assert store.status[row] == int(mp.status)
        assert np.array_equal(store.position[row], mp.position)
        assert np.array_equal(store.norm[row], mp.norm)
        assert store.min_viewing_distance[row] == mp.min_viewing_distance
        assert store.max_viewing_distance[row] == mp.max_viewing_distance
        assert np.array_equal(store.descriptor[row], mp.descriptor)
        assert store.n_obs[row] == len(mp.observations)
        assert store.first_kf[row] == (int(min(mp.observations))
                                       if mp.observations else -1)
    for kf_id, kf in map_db.keyframes.items():
        assert kf_id == kf.id
        for mp_val in kf.map_points:
            if mp_val >= 0:
                mp = map_db.map_points[MpId(int(mp_val))]
                assert kf_id in mp.observations, \
                    "Keyframe has reference to MapPoint but MapPoint not to Keyframe"
    for mp_id, mp in map_db.map_points.items():
        assert mp_id == mp.id
        for kf_id in mp.observations:
            kf = map_db.keyframes[kf_id]
            assert int(mp_id) in kf.map_points.tolist(), \
                "MapPoint has reference to Keyframe but Keyframe not to MapPoint"
    # the incremental covisibility cache must equal a from-scratch recount
    from collections import Counter
    recount: Dict[KfId, Counter] = {}
    for mp in map_db.map_points.values():
        keys = list(mp.observations)
        for i, a in enumerate(keys):
            ca = recount.get(a)
            if ca is None:
                ca = recount[a] = Counter()
            for b in keys[i + 1:]:
                ca[b] += 1
                cb = recount.get(b)
                if cb is None:
                    cb = recount[b] = Counter()
                cb[a] += 1
    # a keyframe whose map points it alone observes has an empty count on
    # both sides: the recount makes one, the cache drops it at zero
    cached = {k: v for k, v in store.covis.items() if v}
    recount = {k: v for k, v in recount.items() if v}
    assert cached == recount, "covisibility cache out of sync"
    if map_db.keyframes:
        ids = set()
        kf_id = max(map_db.keyframes)
        while True:
            assert kf_id not in ids
            ids.add(kf_id)
            nxt = map_db.keyframes[kf_id].previous_kf_id
            if not nxt.valid:
                break
            kf_id = nxt
        assert kf_id == min(map_db.keyframes)
        ids.clear()
        while True:
            assert kf_id not in ids
            ids.add(kf_id)
            nxt = map_db.keyframes[kf_id].next_kf_id
            if not nxt.valid:
                break
            kf_id = nxt
        assert kf_id == max(map_db.keyframes)


def check_positive_depth(position_w: np.ndarray, pose_cw: np.ndarray) -> bool:
    """reference: mapper_helpers.cpp:551-557"""
    z = float(pose_cw[2, :3] @ position_w + pose_cw[2, 3])
    return z > 0


def get_focal_length(kf: Keyframe) -> int:
    """reference: mapper_helpers.cpp:571-574"""
    return kf.shared.camera.get_focal_length()


def check_reprojection_error(pos: np.ndarray, kf: Keyframe,
                             settings: StaticSettings, kp_id: KpId,
                             relative_threshold: float) -> bool:
    """Octave-scaled chi2 reprojection gate (reference:
    mapper_helpers.cpp:576-598)."""
    reprojected, ok = kf.reproject(pos)
    if not ok:
        return False
    point = kf.shared.pts[int(kp_id)]
    rel_sigma_base = get_focal_length(kf) * relative_threshold
    ref_scale = len(settings.scaleFactors) // 2
    octave = int(kf.shared.octave[int(kp_id)])
    sigma2 = (settings.levelSigmaSq[octave] / settings.levelSigmaSq[ref_scale]
              * rel_sigma_base * rel_sigma_base)
    err = float(np.sum((reprojected - point) ** 2))
    return err <= CHI2_INV2D * sigma2


def triangulate_map_point(map_db: MapDB, map_point: MapPoint,
                          settings: StaticSettings,
                          method: str = "tme") -> None:
    """reference: mapper_helpers.cpp:600-722"""
    parameters = settings.parameters.slam
    was_triangulated = map_point.status != MapPointStatus.NOT_TRIANGULATED
    map_point.status = MapPointStatus.NOT_TRIANGULATED
    obs = sorted(map_point.observations.items())
    if len(obs) < 2:
        return

    rays_w = []
    depth_triangulated = False
    for kf_id, kp_id in obs:
        kf = map_db.keyframes[kf_id]
        depth = float(kf.keypoint_depth[int(kp_id)])
        bearing = kf.shared.bearings[int(kp_id)]
        if depth > 0 and not was_triangulated:
            map_point.position = (depth * kf.camera_to_world_rotation() @ bearing
                                  + kf.camera_center())
            depth_triangulated = True
            break
        rays_w.append(kf.camera_to_world_rotation() @ bearing)

    status_if_ok = MapPointStatus.UNSURE
    if not depth_triangulated:
        if len(obs) > 2 and tri.check_triangulation_angle(
                np.array(rays_w), parameters.minTriangulationAngleMultipleObs):
            status_if_ok = MapPointStatus.TRIANGULATED
        elif not tri.check_triangulation_angle(
                np.array(rays_w), parameters.minTriangulationAngleTwoObs):
            return

    if depth_triangulated:
        point = map_point.position
    elif method == "midpoint":
        origins, rays = [], []
        for kf_id, kp_id in obs:
            kf = map_db.keyframes[kf_id]
            origins.append(kf.camera_center())
            rays.append(kf.camera_to_world_rotation() @ kf.shared.bearings[int(kp_id)])
        Xh, ok = tri.triangulate_midpoint(np.array(origins), np.array(rays))
        if not ok:
            return
        point = Xh[:3] / Xh[3]
    else:
        poses, normalized = [], []
        for kf_id, kp_id in obs:
            kf = map_db.keyframes[kf_id]
            npix, ok = kf.shared.camera.normalize_pixel(kf.shared.pts[int(kp_id)])
            if ok:
                normalized.append(npix)
                poses.append(kf.pose_cw[:3])
        if len(normalized) < 2:
            return
        if len(normalized) == 2:
            Xh, ok = tri.triangulate_two_view(poses[0], poses[1],
                                              normalized[0], normalized[1])
        else:
            Xh, ok = tri.triangulate_n_view(np.array(poses), np.array(normalized))
        if not ok or abs(Xh[3]) < 1e-12:
            return
        point = Xh[:3] / Xh[3]

    for kf_id, kp_id in obs:
        kf = map_db.keyframes[kf_id]
        if not check_positive_depth(point, kf.pose_cw):
            return
        if not check_reprojection_error(
                point, kf, settings, kp_id,
                parameters.relativeReprojectionErrorThreshold):
            return

    map_point.position = np.asarray(point, np.float64)
    map_point.status = status_if_ok


@timed
def triangulate_map_points(map_db: MapDB, mps, settings: StaticSettings,
                           method: str = "tme") -> None:
    """Batched ``triangulate_map_point`` over many map points at once
    (reference: mapper_helpers.cpp:600-722 semantics, identical gates).

    One set of vectorized gathers/solves replaces per-point NumPy calls
    (~0.5 ms each); depth-seeded points and non-default methods fall back to
    the scalar path (rare: stereo input only).
    """
    parameters = settings.parameters.slam
    mps = list(mps)
    if method != "tme":
        for mp in mps:
            triangulate_map_point(map_db, mp, settings, method)
        return

    metas = []
    for mp in mps:
        obs = sorted(mp.observations.items())
        if len(obs) < 2:
            mp.status = MapPointStatus.NOT_TRIANGULATED
            continue
        metas.append((mp, obs))
    if not metas:
        return

    rows_kf, rows_kp, n_obs_list = [], [], []
    for mp, obs in metas:
        ks, kps = zip(*obs)
        rows_kf.extend(ks)
        rows_kp.extend(kps)
        n_obs_list.append(len(obs))
    R = len(rows_kf)
    P = len(metas)
    n_obs = np.asarray(n_obs_list, np.int64)
    rows_pt = np.repeat(np.arange(P, dtype=np.int64), n_obs)
    rows_kp_arr = np.fromiter(rows_kp, np.int64, R)

    rays = np.zeros((R, 3))
    depth = np.zeros(R)
    npix = np.zeros((R, 2))
    nok = np.zeros(R, bool)
    pose_rows = np.zeros((R, 3, 4))
    octv = np.zeros(R, np.int64)
    pts2d = np.zeros((R, 2))
    rel = np.zeros(R)
    # group observation rows by keyframe with one stable argsort (the group
    # loops below gather per keyframe; order within a group is irrelevant)
    rows_kf_arr = np.fromiter(rows_kf, np.int64, R)
    order = np.argsort(rows_kf_arr, kind="stable")
    sorted_kf = rows_kf_arr[order]
    cuts = np.flatnonzero(np.diff(sorted_kf)) + 1
    groups = [(KfId(int(rows_kf_arr[part[0]])), part)
              for part in np.split(order, cuts)]
    for kf_id, rs in groups:
        kf = map_db.keyframes[kf_id]
        kps = rows_kp_arr[rs]
        rays[rs] = kf.shared.bearings[kps] @ kf.camera_to_world_rotation().T
        depth[rs] = kf.keypoint_depth[kps]
        pix, okp = kf.shared.camera.normalize_pixel(kf.shared.pts[kps])
        npix[rs] = pix
        nok[rs] = okp
        pose_rows[rs] = kf.pose_cw[:3]
        octv[rs] = kf.shared.octave[kps]
        pts2d[rs] = kf.shared.pts[kps]
        rel[rs] = (get_focal_length(kf)
                   * parameters.relativeReprojectionErrorThreshold)

    # depth-seeded points take the scalar path (status untouched so far, so
    # the scalar function sees the original was_triangulated state)
    has_depth = np.bincount(rows_pt, weights=(depth > 0), minlength=P) > 0
    was_tri = np.array([mp.status != MapPointStatus.NOT_TRIANGULATED
                        for mp, _ in metas])
    fallback = has_depth & ~was_tri
    for i in np.flatnonzero(fallback):
        triangulate_map_point(map_db, metas[i][0], settings, method)
    live = ~fallback
    for i in np.flatnonzero(live):
        metas[i][0].status = MapPointStatus.NOT_TRIANGULATED

    # --- triangulation-angle gates over padded (P, Mo, 3) rays
    Mo = int(n_obs.max())
    start = np.r_[0, np.cumsum(n_obs)[:-1]]
    cum = np.arange(R) - start[rows_pt]
    rays_p = np.zeros((P, Mo, 3))
    mask_p = np.zeros((P, Mo), bool)
    rays_p[rows_pt, cum] = rays
    mask_p[rows_pt, cum] = True
    u = rays_p / np.maximum(np.linalg.norm(rays_p, axis=2, keepdims=True), 1e-12)
    dots = u @ u.transpose(0, 2, 1)     # pairwise ray cosines, BLAS-batched
    pair_mask = (mask_p[:, :, None] & mask_p[:, None, :]
                 & np.triu(np.ones((Mo, Mo), bool), 1)[None])
    cos_multi = np.cos(np.radians(parameters.minTriangulationAngleMultipleObs))
    cos_two = np.cos(np.radians(parameters.minTriangulationAngleTwoObs))
    wide_multi = np.any((dots < cos_multi) & pair_mask, axis=(1, 2))
    wide_two = np.any((dots < cos_two) & pair_mask, axis=(1, 2))
    passed_multi = (n_obs > 2) & wide_multi
    proceed = live & (passed_multi | wide_two)

    n_ok = np.bincount(rows_pt, weights=nok, minlength=P).astype(np.int64)
    proceed &= n_ok >= 2
    if not proceed.any():
        return

    # rank of each normalized-ok observation within its point
    csum = np.cumsum(nok.astype(np.int64))
    seg_before = np.where(start > 0, csum[np.maximum(start - 1, 0)], 0)
    rank = np.where(nok, csum - 1 - seg_before[rows_pt], -1)

    X = np.zeros((P, 3))
    solved = np.zeros(P, bool)

    # two normalized observations: DLT (SVD of the stacked 4x4 design)
    two = proceed & (n_ok == 2)
    if two.any():
        first_row = np.full(P, -1, np.int64)
        second_row = np.full(P, -1, np.int64)
        sel0 = np.flatnonzero(rank == 0)
        sel1 = np.flatnonzero(rank == 1)
        first_row[rows_pt[sel0]] = sel0
        second_row[rows_pt[sel1]] = sel1
        pi = np.flatnonzero(two)
        r0, r1 = first_row[pi], second_row[pi]
        A = np.stack([
            npix[r0, 0, None] * pose_rows[r0, 2] - pose_rows[r0, 0],
            npix[r0, 1, None] * pose_rows[r0, 2] - pose_rows[r0, 1],
            npix[r1, 0, None] * pose_rows[r1, 2] - pose_rows[r1, 0],
            npix[r1, 1, None] * pose_rows[r1, 2] - pose_rows[r1, 1],
        ], axis=1)
        _, _, vt = np.linalg.svd(A)
        Xh = vt[:, -1, :]
        w = Xh[:, 3]
        good = np.abs(w) > 1e-12
        X[pi[good]] = Xh[good, :3] / w[good, None]
        solved[pi[good]] = True

    # >2 normalized observations: accumulated-cost eigen solve
    many = proceed & (n_ok > 2)
    if many.any():
        h = np.concatenate([npix, np.ones((R, 1))], axis=1)
        h = h / np.linalg.norm(h, axis=1, keepdims=True)
        # proj[r,i,k] = h_i * (h . pose[:,k]) — rank-1 outer of h with h@pose
        hp = (h[:, None, :] @ pose_rows)[:, 0]
        proj = h[:, :, None] * hp[:, None, :]
        cost = (pose_rows - proj) * (nok & many[rows_pt])[:, None, None]
        ctc = cost.transpose(0, 2, 1) @ cost
        design = np.zeros((P, 4, 4))
        np.add.at(design, rows_pt, ctc)
        pi = np.flatnonzero(many)
        _, v = np.linalg.eigh(design[pi])
        Xh = v[:, :, 0]
        w = Xh[:, 3]
        good = np.abs(w) > 1e-12
        X[pi[good]] = Xh[good, :3] / w[good, None]
        solved[pi[good]] = True

    # --- positive-depth + octave-scaled chi2 gates on every observation
    Xr = X[rows_pt]
    z = np.einsum("rj,rj->r", pose_rows[:, 2, :3], Xr) + pose_rows[:, 2, 3]
    repro_ok = np.zeros(R, bool)
    err = np.zeros(R)
    for kf_id, rs in groups:
        kf = map_db.keyframes[kf_id]
        pix, okv = kf.reproject_many(X[rows_pt[rs]])
        err[rs] = np.sum((pix - pts2d[rs]) ** 2, axis=1)
        repro_ok[rs] = okv
    ref_scale = len(settings.scaleFactors) // 2
    sigma2 = (settings.levelSigmaSq[octv] / settings.levelSigmaSq[ref_scale]
              * rel * rel)
    row_bad = ~((z > 0) & repro_ok & (err <= CHI2_INV2D * sigma2))
    all_ok = np.bincount(rows_pt, weights=row_bad, minlength=P) == 0

    for i in np.flatnonzero(proceed & solved & all_ok):
        mp = metas[i][0]
        mp.position = X[i].copy()
        mp.status = (MapPointStatus.TRIANGULATED if passed_multi[i]
                     else MapPointStatus.UNSURE)


def triangulate_map_point_first_last_obs(map_db: MapDB, map_point: MapPoint,
                                         settings: StaticSettings) -> None:
    """reference: mapper_helpers.cpp:724-812"""
    parameters = settings.parameters.slam
    map_point.status = MapPointStatus.NOT_TRIANGULATED
    if len(map_point.observations) < 2:
        return
    first_kf = map_db.keyframes[map_point.get_first_observation()]
    last_kf = map_db.keyframes[map_point.get_last_observation()]
    first_kp = int(map_point.observations[first_kf.id])
    last_kp = int(map_point.observations[last_kf.id])

    depth = float(last_kf.keypoint_depth[last_kp])
    if depth > 0:
        map_point.position = (
            depth * last_kf.camera_to_world_rotation() @ last_kf.shared.bearings[last_kp]
            + last_kf.camera_center())
    else:
        if settings.parameters.slam.computeDenseStereoDepth:
            return  # skipping depth-free points (mapper_helpers.cpp:748)
        rays_w = np.array([
            first_kf.camera_to_world_rotation() @ first_kf.shared.bearings[first_kp],
            last_kf.camera_to_world_rotation() @ last_kf.shared.bearings[last_kp]])
        if not tri.check_triangulation_angle(
                rays_w, parameters.minTriangulationAngleTwoObs):
            return
        n1, ok1 = first_kf.shared.camera.normalize_pixel(first_kf.shared.pts[first_kp])
        n2, ok2 = last_kf.shared.camera.normalize_pixel(last_kf.shared.pts[last_kp])
        if not (ok1 and ok2):
            return
        Xh, ok = tri.triangulate_two_view(first_kf.pose_cw[:3], last_kf.pose_cw[:3],
                                          n1, n2)
        if not ok or abs(Xh[3]) < 1e-12:
            return
        map_point.position = Xh[:3] / Xh[3]

    n_ok = 0
    for kf_id, kp_id in sorted(map_point.observations.items()):
        if check_reprojection_error(
                map_point.position, map_db.keyframes[kf_id], settings, kp_id,
                parameters.relativeReprojectionErrorThreshold):
            n_ok += 1
    if n_ok < 2:
        return
    map_point.status = (MapPointStatus.TRIANGULATED
                        if len(map_point.observations) > 2
                        else MapPointStatus.UNSURE)
    map_point.update_descriptor(map_db)


def set_point_cloud_output(map_db: MapDB, kf: Keyframe) -> List[dict]:
    """reference: mapper_helpers.cpp:484-497"""
    store = map_db.mp_store
    vals = kf.map_points[kf.map_points >= 0]
    rows, live = store.rows_of(vals)
    keep = live & (store.status[rows] == int(MapPointStatus.TRIANGULATED))
    rows = rows[keep]
    positions = store.position[rows]
    return [{"id": int(v), "trackId": int(store.objs[r].track_id),
             "position": positions[i].copy()}
            for i, (v, r) in enumerate(zip(vals[keep].tolist(),
                                           rows.tolist()))]


def update_point_cloud_recording(t: float,
                                 records: Dict[MpId, MapPointRecord],
                                 map_points: Dict[MpId, MapPoint]) -> None:
    """reference: mapper_helpers.cpp:881-909"""
    for mp_id, mp in map_points.items():
        if len(mp.observations) < 4:
            continue
        p = mp.position.astype(np.float32)
        if mp_id not in records:
            records[mp_id] = MapPointRecord(
                positions=[MapPointRecordPosition(t, p)], normal=mp.norm.copy())
        elif not np.array_equal(records[mp_id].positions[-1].p, p):
            records[mp_id].positions.append(MapPointRecordPosition(t, p))
            records[mp_id].normal = mp.norm.copy()
    p0 = np.zeros(3, np.float32)
    for mp_id, rec in records.items():
        if not rec.removed and mp_id not in map_points:
            rec.removed = True
            rec.positions.append(MapPointRecordPosition(t, p0))


@timed
def refresh_map_points(current_keyframe: Keyframe, map_db: MapDB,
                       settings: StaticSettings) -> None:
    """Batched descriptor / viewing-cone refresh + status promotion for the
    current keyframe's surviving map points (reference:
    mapper_helpers.cpp:1061-1077).

    Same math as the scalar ``MapPoint.update_descriptor`` /
    ``update_distance_and_norm`` loop (the semantics reference, still used at
    the other call sites), but columnar: one pass assembles per-observation
    arrays (camera centers cached per keyframe), the viewing normals come
    from one vectorized segment sum, and all medoid scans run in ONE native
    CSR call instead of a ctypes round trip per point."""
    from slam_tpu_torch import native

    ps = settings.parameters.slam
    mps = []
    for mp_val in current_keyframe.map_points:
        if mp_val < 0:
            continue
        mp = map_db.map_points[MpId(int(mp_val))]
        if mp.status in (MapPointStatus.NOT_TRIANGULATED, MapPointStatus.BAD):
            continue
        mps.append(mp)
    if not mps:
        return

    n = len(mps)
    positions = np.empty((n, 3))
    kf_row: dict = {}        # kf_id -> row in the center/flag tables
    centers_list = []
    full_list = []
    kfs_list = []
    seg = []                 # map-point index per observation row
    crow = []                # center-table row per observation row
    first_crow = np.empty(n, np.int64)
    first_oct = np.empty(n, np.int64)
    desc_rows = []           # (center row, kp) of full-featured observations
    dcount = np.zeros(n + 1, np.int64)
    for i, mp in enumerate(mps):
        positions[i] = mp.position
        obs_sorted = sorted(mp.observations)
        for kf_id in obs_sorted:
            r = kf_row.get(kf_id)
            if r is None:
                kf = map_db.keyframes[kf_id]
                r = kf_row[kf_id] = len(centers_list)
                centers_list.append(kf.camera_center())
                full_list.append(kf.has_full_features)
                kfs_list.append(kf)
            seg.append(i)
            crow.append(r)
            if full_list[r]:
                desc_rows.append((r, int(mp.observations[kf_id])))
                dcount[i + 1] += 1
        r0 = kf_row[obs_sorted[0]]
        first_crow[i] = r0
        first_oct[i] = int(
            kfs_list[r0].shared.octave[int(mp.observations[obs_sorted[0]])])

    centers = np.asarray(centers_list)
    seg_a = np.asarray(seg, np.int64)
    crow_a = np.asarray(crow, np.int64)

    # viewing normal: mean of unit map-point->camera vectors, summed in the
    # same (map point, sorted kf) order as the scalar loop
    v = centers[crow_a] - positions[seg_a]
    vnorm = np.linalg.norm(v, axis=1)
    vunit = np.zeros_like(v)
    nz = vnorm > 0
    vunit[nz] = v[nz] / vnorm[nz, None]
    norm_sum = np.zeros((n, 3))
    np.add.at(norm_sum, seg_a, vunit)
    counts = np.bincount(seg_a, minlength=n)
    norms = (norm_sum / counts[:, None]).astype(np.float32)

    # min/max viewing distance from the FIRST (lowest-id) observation
    dist0 = np.linalg.norm(centers[first_crow] - positions, axis=1)
    sf = np.asarray(settings.scaleFactors, np.float64)
    max_d = dist0 * sf[first_oct]
    min_d = max_d / float(sf[-1])

    # medoid descriptors: one CSR-batched native scan (n<=2 segments resolve
    # to the first descriptor, identical to the scalar shortcut). The flat
    # descriptor matrix is filled by one masked gather per source keyframe
    # instead of a row copy + stack per observation.
    dptr = np.cumsum(dcount)
    if desc_rows:
        drow = np.asarray([d[0] for d in desc_rows], np.int64)
        dkp = np.asarray([d[1] for d in desc_rows], np.int64)
        flat = np.empty((len(desc_rows), 8), np.uint32)
        for r in np.unique(drow):
            mask = drow == r
            flat[mask] = kfs_list[r].shared.descriptors[dkp[mask]]
        med = native.medoid_descriptor_many(flat, dptr)
    else:
        flat = None
        med = None

    # object attributes per point, columnar mirror in vectorized writes
    # (object.__setattr__ skips the per-attribute write-through)
    min_obs = ps.minObservationsForBA
    store = map_db.mp_store
    rows = np.fromiter((mp._row for mp in mps), np.int64, count=n)
    statuses = np.empty(n, np.int8)
    descs_out = store.descriptor[rows]
    for i, mp in enumerate(mps):
        if med is not None and med[i] >= 0:
            d = flat[dptr[i] + med[i]]
            descs_out[i] = d
            object.__setattr__(mp, "descriptor", d.copy())
        object.__setattr__(mp, "norm", norms[i].copy())
        object.__setattr__(mp, "max_viewing_distance", float(max_d[i]))
        object.__setattr__(mp, "min_viewing_distance", float(min_d[i]))
        st = (MapPointStatus.TRIANGULATED
              if len(mp.observations) >= min_obs else MapPointStatus.UNSURE)
        object.__setattr__(mp, "status", st)
        statuses[i] = int(st)
    store.descriptor[rows] = descs_out
    store.norm[rows] = norms
    store.max_viewing_distance[rows] = max_d
    store.min_viewing_distance[rows] = min_d
    store.status[rows] = statuses


# ---------------------------------------------------------------------------
# addKeyframe orchestration (reference: mapper_helpers.cpp:1011-1278)
# ---------------------------------------------------------------------------


def add_keyframe_common_inner(map_db: MapDB, current_keyframe: Keyframe,
                              kf_decision: bool, settings: StaticSettings,
                              workspace_ba: Optional[WorkspaceBA] = None,
                              loop_closer=None, bow_index=None,
                              viewer_publisher=None, device=None) -> None:
    """reference: mapper_helpers.cpp:1011-1131. Device work runs on
    ``workspace_ba.device`` (backend) or ``device`` (frontend)."""
    ps = settings.parameters.slam
    if workspace_ba is not None:
        device = workspace_ba.device
    assert device is not None, "no device for the frame's solves"
    current_keyframe.uncertainty = (current_keyframe.uncertainty
                                    + map_db.discarded_uncertainty)
    is_backend = loop_closer is not None
    match_tracked_features(current_keyframe, map_db, settings)

    adjacent_kf_ids = compute_adjacent_keyframes(
        current_keyframe, 5, ps.adjacentSpaceSize, map_db, settings,
        visualize=True)
    map_db.adjacent_kf_ids = adjacent_kf_ids

    if kf_decision and is_backend:
        match_local_map_points(current_keyframe, adjacent_kf_ids, map_db,
                               settings, viewer_publisher=viewer_publisher,
                               device=device)
    else:
        if is_backend:
            # a deferred BA must land before the pose-only solve reads the
            # previous keyframe's pose
            finalize_pending_ba(map_db, settings, workspace_ba, loop_closer,
                                bow_index, viewer_publisher)
        if ps.nonKeyFramePoseAdjustment:
            if pose_bundle_adjust(current_keyframe, map_db, settings,
                                  device=device):
                if is_backend:
                    workspace_ba.ba_stats.update(Ba.POSE)
        return

    if not is_backend:
        return
    assert workspace_ba is not None and bow_index is not None

    create_new_map_points(current_keyframe, adjacent_kf_ids, map_db, settings,
                          device=device)
    deduplicate_map_points(current_keyframe, adjacent_kf_ids, map_db, settings)

    # refresh descriptors / norms; promote or demote by observation count
    # (mapper_helpers.cpp:1061-1077)
    refresh_map_points(current_keyframe, map_db, settings)

    # pipelinedLocalBA: the previous keyframe's deferred solve has been
    # overlapping all the host matching above; collect + APPLY it now (this
    # frame's problem must be built from the applied poses), but hold its
    # pipeline tail until after this frame's solve is dispatched — the tail
    # (retriangulation, culling, BoW add, loop closure; ~7 ms host) then
    # also overlaps the device round trip instead of extending it
    prev_pending = collect_pending_ba(workspace_ba, map_db)

    if ps.applyLocalBundleAdjustment:
        deferred = local_bundle_adjust(current_keyframe, workspace_ba, map_db,
                                       ps.localBAProblemSize, settings,
                                       defer=ps.pipelinedLocalBA,
                                       adjacent_kf_ids=adjacent_kf_ids)
    else:
        deferred = False

    if prev_pending is not None:
        prev_kf = map_db.keyframes.get(prev_pending.kf_id)
        if prev_kf is not None:
            _post_ba_tail(
                map_db, prev_kf,
                [k for k in prev_pending.adjacent_kf_ids
                 if k in map_db.keyframes],
                settings, workspace_ba, loop_closer, bow_index,
                viewer_publisher, did_ba=True)

    if deferred and workspace_ba.pending is None:
        # the previous keyframe's tail closed a loop and dropped this
        # frame's in-flight solve as stale — run this frame's tail now
        # (its local BA was superseded by the closure's re-optimization)
        _post_ba_tail(map_db, current_keyframe, adjacent_kf_ids, settings,
                      workspace_ba, loop_closer, bow_index, viewer_publisher,
                      did_ba=False)
    elif not deferred:
        # apply + tail for THIS frame run at the next finalize point when
        # deferred; synchronously here otherwise
        _post_ba_tail(map_db, current_keyframe, adjacent_kf_ids, settings,
                      workspace_ba, loop_closer, bow_index, viewer_publisher,
                      did_ba=ps.applyLocalBundleAdjustment)


def _post_ba_tail(map_db: MapDB, current_keyframe: Keyframe,
                  adjacent_kf_ids: List[KfId], settings: StaticSettings,
                  workspace_ba, loop_closer, bow_index, viewer_publisher,
                  did_ba: bool) -> None:
    """The pipeline tail after local BA (mapper_helpers.cpp:1084-1130):
    retriangulation, culling, BoW registration, loop closure, recording."""
    ps = settings.parameters.slam
    if did_ba:
        # retriangulate current-KF points not locked in by BA
        # (mapper_helpers.cpp:1084-1092), candidates via the columnar store
        store = map_db.mp_store
        vals = current_keyframe.map_points[current_keyframe.map_points >= 0]
        rows, live = store.rows_of(vals)
        keep = live & ((store.status[rows]
                        != int(MapPointStatus.TRIANGULATED))
                       | (store.n_obs[rows] >= 2))
        retri = [store.objs[r] for r in rows[keep].tolist()]
        triangulate_map_points(map_db, retri, settings)

    cull_map_points(current_keyframe, map_db, ps)
    cull_keyframes(adjacent_kf_ids, map_db, bow_index, ps)

    with section("bow_index_add"):
        bow_index.add(current_keyframe, CURRENT_MAP_ID)
    with section("try_loop_closure"):
        closed_loop = loop_closer.try_loop_closure(current_keyframe,
                                                   adjacent_kf_ids)
    if closed_loop:
        if workspace_ba.pending is not None:
            # tail-overlapped mode: a NEWER keyframe's solve is in flight,
            # built from pre-closure poses. The closure just rewrote those
            # poses, so the solve is stale — drop it (the closure's own
            # global/local BA below supersedes it; the reference likewise
            # re-optimizes after correctLoop, mapper_helpers.cpp:1106-1121)
            workspace_ba.pending = None
        if ps.globalBAAfterLoop:
            global_bundle_adjust(current_keyframe.id, map_db, settings,
                                 device=workspace_ba.device)
            workspace_ba.ba_stats.update(Ba.GLOBAL)
        else:
            local_bundle_adjust(current_keyframe, workspace_ba, map_db,
                                ps.loopClosureLocalBAProblemSize, settings)
        # step mode pauses after the post-loop bundle adjust
        # (reference: mapper_helpers.cpp:1116-1120)
        from slam_tpu_torch.utils.commands import step_wait
        step_wait(getattr(loop_closer, "commands", None), viewer_publisher,
                  map_db, workspace_ba, ps,
                  "Bundle adjustment after loop closure done")

    if ps.pointCloudSavePath:
        update_point_cloud_recording(current_keyframe.t,
                                     map_db.map_point_records, map_db.map_points)
    if viewer_publisher is not None:
        viewer_publisher.publish_map(map_db, workspace_ba, settings.parameters.slam)


def finalize_pending_ba(map_db: MapDB, settings: StaticSettings, workspace_ba,
                        loop_closer, bow_index, viewer_publisher=None) -> None:
    """Collect an in-flight deferred local BA (pipelinedLocalBA) and run the
    post-BA pipeline tail for its keyframe. No-op when nothing is pending."""
    if workspace_ba is None or workspace_ba.pending is None:
        return
    pending = collect_pending_ba(workspace_ba, map_db)
    kf = map_db.keyframes.get(pending.kf_id)
    if kf is None:
        return  # keyframe was removed (pose-trail drop) while in flight
    adjacent = [k for k in pending.adjacent_kf_ids if k in map_db.keyframes]
    _post_ba_tail(map_db, kf, adjacent, settings, workspace_ba, loop_closer,
                  bow_index, viewer_publisher, did_ba=True)


def add_keyframe_common_outer(map_db: MapDB, keyframe: Keyframe,
                              keyframe_decision: bool,
                              mapper_input: MapperInput,
                              settings: StaticSettings,
                              workspace_ba=None, loop_closer=None,
                              orb_extractor=None, bow_index=None,
                              viewer_publisher=None, device=None
                              ) -> Tuple[KfId, np.ndarray, List[dict]]:
    """reference: mapper_helpers.cpp:1133-1233. Returns (kf id, result pose,
    point cloud)."""
    pose_trail = mapper_input.pose_trail
    if settings.parameters.slam.useFullPoseTrail:
        # resync existing keyframe odometry poses from the trail
        # (mapper_helpers.cpp:1149-1170)
        for pose in pose_trail[1:]:
            kf_id = KfId(pose.frame_number)
            if kf_id in map_db.keyframes:
                map_db.keyframes[kf_id].orig_pose_cw = np.array(pose.pose_cw)
        # drop keyframes that odometry removed from its trail
        # (mapper_helpers.cpp:1172-1183)
        last_frame = KfId(pose_trail[-1].frame_number)
        trail_numbers = {p.frame_number for p in pose_trail}
        kf = map_db.latest_keyframe()
        while (kf is not None and kf.next_kf_id.valid and kf.id <= last_frame):
            frame_number = int(kf.id)
            nxt = map_db.keyframes.get(kf.next_kf_id)
            if frame_number not in trail_numbers:
                remove_keyframe(KfId(frame_number), map_db, bow_index)
            kf = nxt

    is_backend = orb_extractor is not None
    keyframe.shared = keyframe.shared.clone()
    if keyframe_decision and is_backend:
        keyframe.add_full_features(mapper_input, orb_extractor, bow_index)
        # retain the frame for the map-point-search debug view only when a
        # publisher asked for it (reference: mapper.cpp:370/419 imgDbg copy)
        if (mapper_input.frame is not None and np.ndim(mapper_input.frame) >= 2
                and getattr(getattr(viewer_publisher, "parameters", None),
                            "visualizeMapPointSearch", False)):
            keyframe.shared.img_dbg = np.array(mapper_input.frame)
    else:
        keyframe.add_tracker_features(mapper_input)

    current = map_db.insert_new_keyframe_candidate(
        keyframe, keyframe_decision, pose_trail, settings.parameters.slam)

    add_keyframe_common_inner(map_db, current, keyframe_decision, settings,
                              workspace_ba, loop_closer, bow_index,
                              viewer_publisher, device=device)

    map_db.update_prev_pose(current, keyframe_decision, pose_trail,
                            settings.parameters)
    current_id = current.id
    result_pose = current.pose_cw.copy()
    point_cloud = set_point_cloud_output(map_db, current)

    if not keyframe_decision:
        map_db.discarded_uncertainty = current.uncertainty.copy()
        remove_keyframe(current.id, map_db, bow_index)
    else:
        map_db.discarded_uncertainty = np.zeros((3, 6))
    return current_id, result_pose, point_cloud


def add_keyframe_frontend(map_db: MapDB, keyframe: Keyframe, kf_decision: bool,
                          mapper_input: MapperInput, settings: StaticSettings,
                          *, device) -> Tuple[KfId, np.ndarray, List[dict]]:
    """reference: mapper_helpers.cpp:1235-1247. The pose-only solve runs on
    ``device``."""
    return add_keyframe_common_outer(map_db, keyframe, kf_decision,
                                     mapper_input, settings, device=device)


def add_keyframe_backend(map_db: MapDB, keyframe: Keyframe,
                         keyframe_decision: bool, mapper_input: MapperInput,
                         settings: StaticSettings, workspace_ba, loop_closer,
                         orb_extractor, bow_index, viewer_publisher=None
                         ) -> Tuple[KfId, np.ndarray, List[dict]]:
    """reference: mapper_helpers.cpp:1249-1278"""
    return add_keyframe_common_outer(
        map_db, keyframe, keyframe_decision, mapper_input, settings,
        workspace_ba, loop_closer, orb_extractor, bow_index, viewer_publisher)
