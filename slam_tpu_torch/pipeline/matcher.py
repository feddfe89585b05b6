"""Map-aware matchers: projection search, duplicate fusion, Sim3-guided match
(port of slam_tpu/pipeline/matcher.py).

Rebuild of the map-structure-facing half of the reference matcher suite
(reference: keyframe_matcher.cpp:295-686). Descriptor distances come from
the native host popcount, or above a size threshold from the Hamming matmul
(`ops/hamming.py`) on the device the caller names; geometric gating, the
greedy assignment order, and map mutations stay on host, matching the
reference's sequential semantics exactly.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from slam_tpu_torch.ids import KfId, KpId, MpId
from slam_tpu_torch.map.keyframe import Keyframe
from slam_tpu_torch.map.map_point import MapPoint, MapPointStatus
from slam_tpu_torch.map.mapdb import MapDB
from slam_tpu_torch.ops import matching
from slam_tpu_torch.ops.hamming import (HAMMING_DIST_THR_HIGH, HAMMING_DIST_THR_LOW,
                                  MAX_HAMMING_DIST, hamming_matrix_host)
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.utils.timer import timed

SQRT_CHI2_INV2D = 2.4477  # p = 0.05 (keyframe_matcher.cpp:17)


def _bucket(n: int, q: int = 256) -> int:
    return max(q, ((n + q - 1) // q) * q)


def _distance_matrix(desc1: np.ndarray, desc2: np.ndarray,
                     device) -> np.ndarray:
    """N x M Hamming distances: native host popcount for small/medium
    problems, the Hamming matmul on ``device`` above the crossover.

    The crossover accounts for dispatch latency: a host popcount matrix at
    ~1e9 pairs/s beats a device round trip until several million pairs.
    Device inputs are padded to the reference's 256-row buckets (padding
    rows are cut from the result)."""
    n, m = len(desc1), len(desc2)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.int32)
    from slam_tpu_torch import native
    threshold = (1 << 22) if native.available() else (1 << 16)
    if n * m >= threshold:
        from slam_tpu_torch.ops.hamming import hamming_matrix
        pn, pm = _bucket(n), _bucket(m)
        d1 = np.zeros((pn, 8), np.uint32)
        d1[:n] = desc1
        d2 = np.zeros((pm, 8), np.uint32)
        d2[:m] = desc2
        put = lambda d: torch.from_numpy(d.view(np.int32)).to(device)
        out = hamming_matrix(put(d1), put(d2)).cpu().numpy()
        return out[:n, :m]
    return native.hamming_matrix(desc1, desc2)


@timed
def match_for_loop_closures(kf1: Keyframe, kf2: Keyframe, map_db1: MapDB,
                            map_db2: MapDB, parameters, *,
                            device) -> np.ndarray:
    """reference: keyframe_matcher.cpp:50-158. Returns per-kf1-keypoint index
    into kf2 or -1. ``device`` serves the large-matrix fallback."""
    n1 = kf1.shared.num_keypoints
    n2 = kf2.shared.num_keypoints
    if n1 == 0 or n2 == 0:
        return np.full(n1, -1, np.int64)
    cand1 = kf1.map_points >= 0
    if parameters.requireTringulationForLoopClosures:
        for i in np.where(cand1)[0]:
            mp = map_db1.map_points[MpId(int(kf1.map_points[i]))]
            if mp.status != MapPointStatus.TRIANGULATED:
                cand1[i] = False
    cand2 = kf2.map_points >= 0
    for j in np.where(cand2)[0]:
        mp = map_db2.map_points[MpId(int(kf2.map_points[j]))]
        if mp.status != MapPointStatus.TRIANGULATED:
            cand2[j] = False
    from slam_tpu_torch import native
    matched = native.match_loop_closure(
        kf1.shared.descriptors, kf1.shared.groups, cand1,
        kf2.shared.descriptors, kf2.shared.groups, cand2,
        parameters.loopClosureFeatureMatchLoweRatio,
        HAMMING_DIST_THR_LOW, MAX_HAMMING_DIST)
    if matched is not None:
        return matching.apply_angle_check(matched, kf1.shared.angle,
                                          kf2.shared.angle)
    dist = _distance_matrix(kf1.shared.descriptors, kf2.shared.descriptors,
                            device)
    return matching.match_loop_closure_descriptors(
        dist, kf1.shared.groups, kf2.shared.groups, cand1, cand2,
        kf1.shared.angle, kf2.shared.angle,
        lowe_ratio=parameters.loopClosureFeatureMatchLoweRatio)


@timed
def match_for_triangulation(kf1: Keyframe, kf2: Keyframe,
                            settings: StaticSettings, *,
                            device) -> np.ndarray:
    """reference: keyframe_matcher.cpp:160-293 (matchForTriangulationDBoW).
    Returns an (B, 2) int64 array of (kf1 keypoint, kf2 keypoint) pairs."""
    n1 = kf1.shared.num_keypoints
    n2 = kf2.shared.num_keypoints
    if n1 == 0 or n2 == 0:
        return np.zeros((0, 2), np.int64)
    E12 = matching.create_E_21(
        kf2.pose_cw[:3, :3], kf2.pose_cw[:3, 3],
        kf1.pose_cw[:3, :3], kf1.pose_cw[:3, 3])
    sf = settings.scaleFactors
    scale_1 = np.asarray(sf)[np.clip(kf1.shared.octave, 0, len(sf) - 1)]
    free1 = kf1.map_points < 0
    free2 = kf2.map_points < 0
    from slam_tpu_torch import native
    sin_thr = np.sin(np.radians(
        settings.parameters.slam.epipolarCheckThresholdDegrees) * scale_1)
    matched = native.match_triangulation(
        kf1.shared.descriptors, kf1.shared.groups, free1,
        kf1.shared.bearings, sin_thr,
        kf2.shared.descriptors, kf2.shared.groups, free2,
        kf2.shared.bearings, E12, HAMMING_DIST_THR_LOW)
    if matched is not None:
        checked = matching.apply_angle_check(matched, kf1.shared.angle,
                                             kf2.shared.angle)
        sel = np.flatnonzero(checked >= 0)
        return np.stack([sel, checked[sel]], axis=1)
    epi = matching.epipolar_inlier_matrix(
        kf1.shared.bearings, kf2.shared.bearings, E12, scale_1,
        settings.parameters.slam.epipolarCheckThresholdDegrees)
    dist = _distance_matrix(kf1.shared.descriptors, kf2.shared.descriptors,
                            device)
    pairs = matching.match_for_triangulation(
        dist, kf1.shared.groups, kf2.shared.groups, free1, free2, epi,
        kf1.shared.angle, kf2.shared.angle)
    return np.asarray(pairs, np.int64).reshape(-1, 2)


@timed
def search_by_projection(kf: Keyframe, mp_ids: List[MpId], map_db: MapDB,
                         threshold: float, settings: StaticSettings,
                         precomp=None, data_publisher=None, *,
                         device) -> int:
    """Project local map points into the keyframe and claim unmatched
    keypoints (reference: keyframe_matcher.cpp:295-414).

    ``precomp``, when given, is (mps, pix, visible, d_all, cos_all,
    min_d_all, max_d_all, descs) for exactly ``mp_ids`` — the same columns
    this function would derive itself (identical formulas/dtypes), handed
    over by a caller that already computed them for its own gating.

    ``data_publisher`` with ``visualizeMapPointSearch`` enabled receives the
    search debug view (reference: keyframe_matcher.cpp:305-310, 403-411):
    in-image candidate projections, accepted (projection, keypoint) pairs,
    and the keypoints left unmatched. Unlike the reference we publish even
    without a retained debug frame (the renderer draws on black)."""
    if not mp_ids:
        return 0
    visualize = bool(getattr(getattr(data_publisher, "parameters", None),
                             "visualizeMapPointSearch", False))
    vis_matched: list = []
    view_angle_limit_cos = 0.5
    sf = settings.scaleFactors
    ref_scale = float(sf[len(sf) // 2])
    match_count = 0

    if precomp is None:
        mps = [map_db.map_points[m] for m in mp_ids]
        positions = np.stack([mp.position for mp in mps])
        pix, visible = kf.reproject_many(positions)
        cam_center = kf.camera_center()
        # vectorized per-candidate geometry (identical math to scalar gates)
        mp_to_kf_all = (cam_center - positions).astype(np.float32)
        d_all = np.linalg.norm(mp_to_kf_all, axis=1)
        norms_all = np.stack([mp.norm for mp in mps])
        cos_all = (np.sum(mp_to_kf_all * norms_all, axis=1)
                   / np.maximum(d_all, 1e-12))
        max_d_all = np.array([mp.max_viewing_distance for mp in mps])
        min_d_all = np.array([mp.min_viewing_distance for mp in mps])
        mp_descs = np.stack([mp.descriptor for mp in mps])
    else:
        (mps, pix, visible, d_all, cos_all, min_d_all, max_d_all,
         mp_descs) = precomp
    pred_all = MapPoint.predict_scale_levels(
        np.maximum(max_d_all, 1e-12), np.maximum(d_all, 1e-12), settings)

    def _publish_search():
        unmatched = kf.shared.pts[kf.map_points < 0]
        data_publisher.visualize_map_point_search(
            kf.shared.img_dbg, vis_matched, pix[visible], unmatched)

    # "already owned by a live map point" per keypoint, maintained
    # incrementally as the greedy loop claims keypoints (identical to the
    # reference's at-iteration ownership check, keyframe_matcher.cpp:339-344:
    # ownership only changes here through add_observation on the claimed slot)
    owned = np.zeros(kf.shared.num_keypoints, bool)
    for j in np.flatnonzero(kf.map_points >= 0):
        mp_j = map_db.map_points.get(MpId(int(kf.map_points[j])))
        owned[j] = mp_j is not None and len(mp_j.observations) > 0

    # ONE fused native pass over the surviving candidates: radius search,
    # best/second Hamming + octaves, accept rule, sequential ownership claims
    # — identical semantics to the Python loop below (its NumPy twin)
    from slam_tpu_torch import native
    fs = kf.shared.feature_search
    if fs is not None:
        with np.errstate(invalid="ignore"):
            keep = (visible & (d_all >= min_d_all) & (d_all <= max_d_all)
                    & (cos_all >= view_angle_limit_cos))
        qsel = np.flatnonzero(keep)
        if len(qsel) == 0:
            if visualize:
                _publish_search()
            return 0
        shrink = np.where(cos_all[qsel] > 0.998, 2.5 / 4.0, 1.0)
        radii = (shrink * threshold
                 * np.asarray(sf, np.float64)[pred_all[qsel]] / ref_scale)
        owned_u8 = owned.astype(np.uint8)
        matched = native.project_greedy_claim(
            fs._xs, fs._ys, fs._order.astype(np.int64),
            kf.shared.descriptors, kf.shared.octave, owned_u8,
            pix[qsel, 0], pix[qsel, 1], radii.astype(np.float32),
            mp_descs[qsel], HAMMING_DIST_THR_HIGH, 0.8)
        if matched is not None:
            for qi, j in zip(qsel, matched):
                if j >= 0:
                    mp = mps[qi]
                    kf.add_observation(mp.id, KpId(int(j)))
                    mp.add_observation(kf.id, KpId(int(j)))
                    match_count += 1
                    if visualize:
                        vis_matched.append((pix[qi], kf.shared.pts[int(j)]))
            if visualize:
                _publish_search()
            return match_count

    dist_all = _distance_matrix(mp_descs, kf.shared.descriptors, device)
    for k, mp in enumerate(mps):
        if not visible[k]:
            continue
        d = float(d_all[k])
        if d < min_d_all[k] or d > max_d_all[k]:
            continue
        viewing_cos = float(cos_all[k])
        if viewing_cos < view_angle_limit_cos:
            continue
        pred_level = int(pred_all[k])
        # small-view-angle radius shrink (keyframe_matcher.cpp:335-338)
        r = 2.5 / 4.0 if viewing_cos > 0.998 else 1.0
        radius = r * threshold * float(sf[pred_level]) / ref_scale
        idxs = kf.get_features_around(pix[k], radius)
        if len(idxs) == 0:
            continue
        cand = np.zeros(kf.shared.num_keypoints, bool)
        cand[idxs] = True
        cand &= ~owned
        best_idx, best_d, best_l, second_d, second_l = matching.radius_best_match(
            dist_all[k], cand, kf.shared.octave)
        if best_idx == -1:
            continue
        if best_d <= HAMMING_DIST_THR_HIGH:
            if best_l == second_l and best_d > 0.8 * second_d:
                continue
            kf.add_observation(mp.id, KpId(best_idx))
            mp.add_observation(kf.id, KpId(best_idx))
            owned[best_idx] = True
            match_count += 1
            if visualize:
                vis_matched.append((pix[k], kf.shared.pts[best_idx]))
    if visualize:
        _publish_search()
    return match_count


class _MpColumnCache:
    """Loop-invariant map-point attribute columns shared by the
    ``replace_duplication`` calls of one dedup pass.

    Positions/norms/descriptors/viewing distances of surviving points never
    change during a pass (merges only rewire observation links), so the
    Python attribute-walk that builds the stacked arrays runs at most ONCE
    per pass: ``prime`` builds the columns over the UNION of every
    candidate id the pass can see (current + adjacent keyframes; merges only
    rewrite slots to ids within that union), and each ``lookup`` reduces to
    vectorized gathers from the primed arrays. Liveness and observation-link
    gating are still re-derived on every call (the merge loop's per-row
    rechecks, see ``replace_duplication``)."""

    def __init__(self, map_db: MapDB):
        self.map_db = map_db
        self.key = None
        self.mps = None
        self._primed_vals = None
        self._primed_lookup_key = None

    def prime(self, union_vals: np.ndarray) -> None:
        """Build the columns once for a sorted unique id array — pure
        vectorized gathers from the MapDB columnar store."""
        union_vals = np.asarray(union_vals, np.int64)
        store = self.map_db.mp_store
        rows, live = store.rows_of(union_vals)
        self._primed_vals = union_vals
        self._primed_lookup_key = None
        self._p_mps = [store.objs[r] if ok else None
                       for r, ok in zip(rows.tolist(), live.tolist())]
        self._p_positions = store.position[rows]
        self._p_norms = store.norm[rows]
        self._p_descs = store.descriptor[rows]
        self._p_max_d = store.max_viewing_distance[rows]
        self._p_min_d = store.min_viewing_distance[rows]
        st = store.status[rows]
        self._p_status_ok = (live
                             & (st != int(MapPointStatus.BAD))
                             & (st != int(MapPointStatus.NOT_TRIANGULATED)))

    def _lookup_primed(self, vals: np.ndarray) -> "_MpColumnCache":
        uv = self._primed_vals
        idx = np.searchsorted(uv, vals)
        idx_c = np.minimum(idx, len(uv) - 1)
        hit = (uv[idx_c] == vals) if len(uv) else np.zeros(len(vals), bool)
        rows = np.where(hit, idx_c, 0)
        self.vals = np.where(hit, vals, -1)
        # map-point OBJECTS are only touched for the few rows that survive
        # the static gates — resolve them lazily via mp_at instead of
        # materializing a Python list over every candidate id per call
        self.mps = None
        self._lookup_rows = rows
        self._lookup_hit = hit
        self.positions = self._p_positions[rows]
        self.norms = self._p_norms[rows]
        self.descs = self._p_descs[rows]
        self.max_d = self._p_max_d[rows]
        self.min_d = self._p_min_d[rows]
        self.status_ok = self._p_status_ok[rows] & hit
        return self

    def mp_at(self, i: int):
        """The map-point object of lookup row ``i`` (None when the id was
        absent) — lazy on the primed path, see ``_lookup_primed``."""
        if self.mps is not None:
            return self.mps[i]
        if not self._lookup_hit[i]:
            return None
        return self._p_mps[int(self._lookup_rows[i])]

    def lookup(self, mp_ids: List[MpId], key=None):
        if self._primed_vals is not None:
            # dedup calls the same candidate list once per adjacent keyframe
            # (the key only changes when a merge rewrites the current
            # keyframe's slots) — every derived column is a pure function of
            # the primed snapshot and the id list, so an equal key means the
            # previous lookup's state is already exactly right
            if key is not None and key == self._primed_lookup_key:
                return self
            self._primed_lookup_key = key
            n = len(mp_ids)
            vals = (mp_ids if isinstance(mp_ids, np.ndarray)
                    else np.fromiter((int(m) for m in mp_ids), np.int64, n))
            return self._lookup_primed(vals.astype(np.int64, copy=False))
        if key is None:
            key = tuple(int(m) for m in mp_ids)
        if key != self.key:
            self.key = key
            mps = [self.map_db.map_points.get(m) for m in mp_ids]
            self.mps = mps
            n = len(mps)
            self.vals = np.fromiter((int(m) for m in mp_ids), np.int64, n)
            self.positions = np.zeros((n, 3))
            self.norms = np.zeros((n, 3), np.float32)
            self.descs = np.zeros((n, 8), np.uint32)
            self.max_d = np.zeros(n)
            self.min_d = np.zeros(n)
            # build-time status gate: statuses only move BAD-ward during a
            # dedup pass (merges), so this stays a SUPERSET of the rows the
            # at-call scalar check would pass — the merge loop's mutable
            # rechecks make over-inclusion harmless
            self.status_ok = np.zeros(n, bool)
            for k, mp in enumerate(mps):
                if mp is None:
                    continue
                self.positions[k] = mp.position
                self.norms[k] = mp.norm
                self.descs[k] = mp.descriptor
                self.max_d[k] = mp.max_viewing_distance
                self.min_d[k] = mp.min_viewing_distance
                self.status_ok[k] = mp.status not in (
                    MapPointStatus.BAD, MapPointStatus.NOT_TRIANGULATED)
        return self


@timed
def replace_duplication(kf: Keyframe, mp_ids: Iterable[MpId], margin: float,
                        map_db: MapDB, settings: StaticSettings,
                        cache: Optional[_MpColumnCache] = None,
                        cache_key=None) -> int:
    """Fuse map points duplicated by projection
    (reference: keyframe_matcher.cpp:416-529)."""
    erased: set = set()
    fused = 0
    sf = settings.scaleFactors
    base_scale = float(sf[len(sf) // 2])

    # vectorized geometric gating: positions never change during the loop
    # (only observation links do), so projections/distances are precomputed
    mp_ids = list(mp_ids)
    cols = (cache if cache is not None else _MpColumnCache(map_db)).lookup(
        mp_ids, key=cache_key)
    # candidate rows, fully vectorized: build-time status gate (a safe
    # superset, see _MpColumnCache) and "not already observed in kf" via the
    # keyframe-side membership (kf.map_points[kp] == mp.id <=> kf.id in
    # mp.observations, the audited link invariant); the merge loop rechecks
    # every mutable condition per row
    kf_vals = kf.map_points
    rows = np.flatnonzero(cols.status_ok & (cols.vals >= 0)
                          & ~np.isin(cols.vals, kf_vals[kf_vals >= 0],
                                     kind="table"))
    if len(rows) == 0:
        return 0
    positions = cols.positions[rows]
    pix_all, in_image_all = kf.reproject_many(positions)
    mp_to_kf_all = (kf.camera_center() - positions).astype(np.float32)
    dist_all = np.linalg.norm(mp_to_kf_all, axis=1)
    norms_all = cols.norms[rows]
    cos_all = (np.sum(mp_to_kf_all * norms_all, axis=1)
               / np.maximum(dist_all, 1e-12))

    # precompute the radius-search + Hamming argmin for every candidate in
    # ONE native pass: descriptors/positions/viewing cones never change
    # during the merge loop (replace_with only rewires observation links),
    # so the per-candidate best match is loop-invariant
    from slam_tpu_torch import native
    fs = kf.shared.feature_search
    pre_best = None
    if fs is not None:
        pred_all = MapPoint.predict_scale_levels(
            cols.max_d[rows], dist_all, settings)
        radii = (margin * np.asarray(sf, np.float64)[pred_all]
                 / base_scale * SQRT_CHI2_INV2D).astype(np.float32)
        pre = native.radius_hamming_best(
            fs._xs, fs._ys, fs._order.astype(np.int64),
            kf.shared.descriptors, kf.shared.octave,
            pix_all[:, 0], pix_all[:, 1], radii,
            cols.descs[rows])
        if pre is not None:
            pre_best = pre

    # with the fused native pre-pass, every gate except the mutable-state
    # rechecks is loop-invariant — restrict the sequential loop to the rows
    # that could possibly merge (skipped rows have no side effects, so this
    # is exactly equivalent to the full scan; NaN comparisons negated to
    # match the scalar short-circuit semantics)
    if pre_best is not None:
        bi_all, bd_all = pre_best
        with np.errstate(invalid="ignore"):
            static_ok = (in_image_all
                         & ~((dist_all < cols.min_d[rows])
                             | (dist_all > cols.max_d[rows]))
                         & np.any(norms_all != 0, axis=1)
                         & ~(cos_all < 0.5)
                         & (bi_all >= 0) & (bd_all <= HAMMING_DIST_THR_LOW))
        iter_rows = np.flatnonzero(static_ok)
    else:
        iter_rows = range(len(rows))

    for k in iter_rows:
        src = rows[k]
        mp_id, mp = mp_ids[src], cols.mp_at(src)
        if mp is None:
            continue
        if mp_id in erased or mp.id not in map_db.map_points:
            continue
        # re-check mutable state: an earlier merge may have linked this map
        # point to the keyframe or changed its status (matches the
        # reference's at-iteration checks, keyframe_matcher.cpp:429-439)
        if kf.id in mp.observations:
            continue
        if mp.status in (MapPointStatus.BAD, MapPointStatus.NOT_TRIANGULATED):
            continue
        if not in_image_all[k]:
            continue
        d = float(dist_all[k])
        if d < mp.min_viewing_distance or d > mp.max_viewing_distance:
            continue
        if not mp.norm.any():
            continue
        if cos_all[k] < 0.5:
            continue
        if pre_best is not None:
            bi, bd = int(pre_best[0][k]), int(pre_best[1][k])
            if bi < 0 or bd > HAMMING_DIST_THR_LOW:
                continue
            best_dist, best_kp = bd, KpId(bi)
        else:
            pix = pix_all[k]
            pred_level = mp.predict_scale_level(d, settings)
            r = margin * float(sf[pred_level]) / base_scale * SQRT_CHI2_INV2D
            idxs = kf.get_features_around(pix, r)
            if len(idxs) == 0:
                continue
            dists = native.hamming_row(mp.descriptor, kf.shared.descriptors[idxs])
            best = int(np.argmin(dists))
            best_dist = int(dists[best])
            best_kp = KpId(int(idxs[best]))
            if best_dist > HAMMING_DIST_THR_LOW:
                continue
        matched_mp_id = int(kf.map_points[int(best_kp)])
        if matched_mp_id < 0:
            mp.add_observation(kf.id, best_kp)
            kf.add_observation(mp.id, best_kp)
        else:
            matched_mp = map_db.map_points[MpId(matched_mp_id)]
            # keep the point with more observations (keyframe_matcher.cpp:508-522)
            if len(mp.observations) < len(matched_mp.observations):
                if matched_mp.status == MapPointStatus.NOT_TRIANGULATED:
                    matched_mp.erase_observation(kf.id)
                    kf.map_points[int(best_kp)] = int(mp.id)
                    mp.add_observation(kf.id, best_kp)
                else:
                    mp.replace_with(map_db, matched_mp)
                erased.add(mp_id)
            else:
                matched_mp.replace_with(map_db, mp)
                erased.add(MpId(matched_mp_id))
        fused += 1
    return fused


def find_matches_transformed_mps(mp_ids_a: np.ndarray,
                                 already_matched_in_a: np.ndarray,
                                 kf_b: Keyframe,
                                 rot_baw: np.ndarray, trans_baw: np.ndarray,
                                 map_db: MapDB, margin: float,
                                 settings: StaticSettings) -> np.ndarray:
    """One direction of the Sim3-guided matching
    (reference: keyframe_matcher.cpp:552-631), vectorized: one batched
    reprojection + one fused native radius/Hamming pass over all candidates."""
    sf = settings.scaleFactors
    n = len(mp_ids_a)
    matches = np.full(n, -1, np.int64)

    # candidate gates via the columnar store (one gather per column)
    store = map_db.mp_store
    vals = np.asarray(mp_ids_a, np.int64)
    rows, live = store.rows_of(vals)
    keep = (~np.asarray(already_matched_in_a, bool) & live
            & (store.status[rows] == int(MapPointStatus.TRIANGULATED)))
    cand_rows = rows[keep]
    if not keep.any():
        return matches
    cand_i = np.flatnonzero(keep)
    cand_mp = [store.objs[r] for r in cand_rows.tolist()]

    pos_w = store.position[cand_rows]
    pos_b = pos_w @ rot_baw.T + trans_baw
    pix, ok = kf_b.shared.camera.ray_to_pixel(pos_b)
    ok = ok & kf_b.shared.camera.is_valid_pixel(pix)
    vdist = np.linalg.norm(pos_b, axis=1)
    min_d = store.min_viewing_distance[cand_rows]
    max_d = store.max_viewing_distance[cand_rows]
    ok &= (vdist >= min_d) & (vdist <= max_d)
    if not ok.any():
        return matches
    sel = np.flatnonzero(ok)
    pred = MapPoint.predict_scale_levels(max_d[sel], vdist[sel],
                                         settings).astype(np.int32)
    radii = margin * np.asarray(sf, np.float64)[pred]

    from slam_tpu_torch import native
    fs = kf_b.shared.feature_search
    pre = None
    if fs is not None:
        pre = native.radius_hamming_best(
            fs._xs, fs._ys, fs._order.astype(np.int64),
            kf_b.shared.descriptors, kf_b.shared.octave,
            pix[sel, 0], pix[sel, 1], radii,
            store.descriptor[cand_rows[sel]],
            qlvl_min=pred - 1, qlvl_max=pred)
    if pre is not None:
        best_j, best_d = pre
        hit = (best_j >= 0) & (best_d <= HAMMING_DIST_THR_HIGH)
        for t in np.flatnonzero(hit):
            matches[cand_i[sel[t]]] = int(best_j[t])
        return matches

    # NumPy fallback (no native toolchain)
    for t, k in enumerate(sel):
        mp = cand_mp[k]
        idxs = kf_b.get_features_around(pix[k], float(radii[t]))
        if len(idxs) == 0:
            continue
        octv = kf_b.shared.octave[idxs]
        level_ok = (octv >= pred[t] - 1) & (octv <= pred[t])
        if not level_ok.any():
            continue
        cand = idxs[level_ok]
        from slam_tpu_torch.ops.hamming import hamming_matrix_host
        dd = hamming_matrix_host(mp.descriptor[None], kf_b.shared.descriptors[cand])[0]
        kk = int(np.argmin(dd))
        if int(dd[kk]) <= HAMMING_DIST_THR_HIGH:
            matches[cand_i[k]] = int(cand[kk])
    return matches


def match_map_points_sim3(kf1: Keyframe, kf2: Keyframe, transform12: np.ndarray,
                          map_db: MapDB,
                          matches: List[Tuple[MpId, MpId]],
                          settings: StaticSettings) -> None:
    """Bidirectional Sim3-guided matching with mutual-consistency filter;
    extends ``matches`` in place (reference: keyframe_matcher.cpp:633-686)."""
    margin = 7.5
    already1 = np.zeros(len(kf1.map_points), bool)
    already2 = np.zeros(len(kf2.map_points), bool)
    for mp1, mp2 in matches:
        already1[int(map_db.map_points[mp1].observations[kf1.id])] = True
        already2[int(map_db.map_points[mp2].observations[kf2.id])] = True

    t21w = np.linalg.inv(transform12) @ kf1.pose_cw
    m_2_in_1 = find_matches_transformed_mps(
        kf1.map_points, already1, kf2, t21w[:3, :3], t21w[:3, 3],
        map_db, margin, settings)
    t12w = transform12 @ kf2.pose_cw
    m_1_in_2 = find_matches_transformed_mps(
        kf2.map_points, already2, kf1, t12w[:3, :3], t12w[:3, 3],
        map_db, margin, settings)

    for i in range(len(m_2_in_1)):
        j = int(m_2_in_1[i])
        if j < 0:
            continue
        if int(m_1_in_2[j]) == i:
            matches.append((MpId(int(kf1.map_points[i])),
                            MpId(int(kf2.map_points[j]))))
