"""Keyframe matcher suite over dense Hamming matrices.

Rebuild of the reference matcher semantics (reference: keyframe_matcher.cpp)
on top of the MXU distance matrix from `ops/hamming.py`:

  - the BoW *node bucketing* the reference iterates (keyframe_matcher.cpp:70,
    198) becomes a same-group mask over the dense matrix — the dense scan is
    the TPU fast path, the group mask preserves which candidates are
    considered;
  - the sequential greedy one-to-one assignment and tie-breaking order of the
    reference loops is reproduced exactly on host (it affects which matches
    form, and downstream trajectories depend on it);
  - the 30-wide-bin orientation-consistency vote replicates
    openvslam/match_angle_checker.h:72-83 including its ``round(delta/30)``
    binning.

Scalar thresholds come from match_base.h via `ops/hamming.py`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from slam_tpu_torch.ops.hamming import (HAMMING_DIST_THR_HIGH, HAMMING_DIST_THR_LOW,
                                  MAX_HAMMING_DIST)

ANGLE_HISTOGRAM_LENGTH = 30  # match_angle_checker.h:20
ANGLE_NUM_BINS_KEEP = 3      # match_angle_checker.h:20


def skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64)


def create_E_21(rot_1w: np.ndarray, trans_1w: np.ndarray,
                rot_2w: np.ndarray, trans_2w: np.ndarray) -> np.ndarray:
    """Essential matrix from two known world-to-camera poses
    (reference: openvslam/essential_solver.cc:157-162)."""
    rot_21 = rot_2w @ rot_1w.T
    trans_21 = -rot_21 @ trans_1w + trans_2w
    return skew(trans_21) @ rot_21


def epipolar_inlier_matrix(bearings_1: np.ndarray, bearings_2: np.ndarray,
                           E_12: np.ndarray, scale_1: np.ndarray,
                           residual_deg_thr: float) -> np.ndarray:
    """(N1, N2) epipolar-residual gate (reference: keyframe_matcher.cpp:23-44).

    residual = pi/2 - |acos(cos(b1, E12 b2))| must stay below
    thr_rad * scale_factor(octave of keypoint 1).
    """
    ep1 = bearings_2 @ E_12.T                     # (N2, 3) epiplane normals in cam1
    norm = np.linalg.norm(ep1, axis=1)
    norm = np.maximum(norm, 1e-12)
    cosr = (bearings_1 @ ep1.T) / norm[None, :]   # (N1, N2)
    # pi/2 - arccos(c) < thr  <=>  c < sin(thr)  (arccos is decreasing), an
    # exact arccos-free form of the reference's signed residual test — note
    # negative-cosine pairs still always pass, as in the reference
    thr = np.radians(residual_deg_thr) * np.asarray(scale_1)
    return cosr < np.sin(thr)[:, None]


def angle_check_invalid(delta_angles: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Orientation-consistency vote; returns mask of matches to invalidate.

    Replicates angle_checker: bin = round(delta/30) over delta in [0,360),
    keep the 3 most-populated bins, reject the rest
    (match_angle_checker.h:72-123).
    """
    out = np.zeros_like(valid, dtype=bool)
    idx = np.where(valid)[0]
    if len(idx) == 0:
        return out
    d = delta_angles[idx].astype(np.float64)
    d = np.where(d < 0.0, d + 360.0, d)
    d = np.where(d >= 360.0, d - 360.0, d)
    bins = np.rint(d * (1.0 / ANGLE_HISTOGRAM_LENGTH)).astype(int)
    counts = np.bincount(bins, minlength=ANGLE_HISTOGRAM_LENGTH)
    keep = np.argsort(-counts, kind="stable")[:ANGLE_NUM_BINS_KEEP]
    bad = ~np.isin(bins, keep)
    out[idx[bad]] = True
    return out


def apply_angle_check(matched: np.ndarray, angles1: np.ndarray,
                      angles2: np.ndarray, as_pairs: bool = False):
    """Orientation-consistency post-filter shared by the matchers: invalidate
    matches outside the top-3 rotation-histogram bins. Used to finish the
    native fused matchers (which return raw greedy assignments)."""
    valid = matched >= 0
    deltas = np.zeros(len(matched), dtype=np.float64)
    deltas[valid] = angles1[valid] - angles2[matched[valid]]
    bad = angle_check_invalid(deltas, valid)
    matched = matched.copy()
    matched[bad] = -1
    if as_pairs:
        return [(int(i), int(matched[i])) for i in np.where(matched >= 0)[0]]
    return matched


def _bucket_order(groups: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Iteration order of the reference's BoW-bucket loops: ascending node id,
    then ascending keypoint index within the node."""
    idx = np.where(cand)[0]
    return idx[np.argsort(groups[idx], kind="stable")]


def _group_buckets(groups: np.ndarray, cand: np.ndarray):
    """group id -> sorted candidate indices; makes the per-query scan touch
    only the ~N/num_groups same-group keypoints instead of full rows."""
    idx = np.where(cand)[0]
    order = np.argsort(groups[idx], kind="stable")
    idx = idx[order]
    g = groups[idx]
    buckets = {}
    if len(idx):
        cuts = np.flatnonzero(np.diff(g)) + 1
        for part, gval in zip(np.split(idx, cuts), g[np.r_[0, cuts]]):
            buckets[int(gval)] = part
    return buckets


def match_loop_closure_descriptors(
    dist: np.ndarray,
    groups1: np.ndarray, groups2: np.ndarray,
    cand1: np.ndarray, cand2: np.ndarray,
    angles1: np.ndarray, angles2: np.ndarray,
    lowe_ratio: float,
    check_orientation: bool = True,
) -> np.ndarray:
    """BoW-bucketed best/second-best matching with Lowe ratio + angle vote.

    Mirrors ``matchForLoopClosures`` (keyframe_matcher.cpp:50-158). Returns
    (N1,) int array: index into kf2 or -1.
    """
    n1 = dist.shape[0]
    matched = np.full(n1, -1, dtype=np.int64)
    used2 = np.zeros(dist.shape[1], dtype=bool)
    buckets = _group_buckets(groups2, cand2)

    for i in _bucket_order(groups1, cand1):
        js = buckets.get(int(groups1[i]))
        if js is None:
            continue
        js = js[~used2[js]]
        if len(js) == 0:
            continue
        d = dist[i, js]
        order = np.argsort(d, kind="stable")
        best = int(js[order[0]])
        best_d = int(d[order[0]])
        second_d = int(d[order[1]]) if len(order) > 1 else MAX_HAMMING_DIST
        if best_d > HAMMING_DIST_THR_LOW:
            continue
        if lowe_ratio * second_d < best_d:
            continue
        matched[i] = best
        used2[best] = True

    if check_orientation:
        valid = matched >= 0
        deltas = np.zeros(n1, dtype=np.float64)
        deltas[valid] = angles1[valid] - angles2[matched[valid]]
        bad = angle_check_invalid(deltas, valid)
        matched[bad] = -1
    return matched


def match_for_triangulation(
    dist: np.ndarray,
    groups1: np.ndarray, groups2: np.ndarray,
    free1: np.ndarray, free2: np.ndarray,
    epi_inlier: np.ndarray,
    angles1: np.ndarray, angles2: np.ndarray,
    check_orientation: bool = True,
) -> List[Tuple[int, int]]:
    """Unmatched-feature matching with epipolar gate for new map points.

    Mirrors ``matchForTriangulationDBoW`` (keyframe_matcher.cpp:160-293):
    candidates share a vocabulary group, are free (no map point) on both
    sides, distance <= THR_LOW, epipolar inlier; the reference's scan keeps
    the LAST candidate achieving the running-minimum distance, and assignment
    is greedy one-to-one in bucket order.
    """
    n1 = dist.shape[0]
    matched = np.full(n1, -1, dtype=np.int64)
    used2 = np.zeros(dist.shape[1], dtype=bool)
    buckets = _group_buckets(groups2, free2)

    for i in _bucket_order(groups1, free1):
        js = buckets.get(int(groups1[i]))
        if js is None:
            continue
        keep = (~used2[js]) & (dist[i, js] <= HAMMING_DIST_THR_LOW) & epi_inlier[i, js]
        js = js[keep]
        if len(js) == 0:
            continue
        d = dist[i, js]
        m = d.min()
        best = int(js[np.where(d == m)[0][-1]])  # ties -> last index wins
        matched[i] = best
        used2[best] = True

    if check_orientation:
        valid = matched >= 0
        deltas = np.zeros(n1, dtype=np.float64)
        deltas[valid] = angles1[valid] - angles2[matched[valid]]
        bad = angle_check_invalid(deltas, valid)
        matched[bad] = -1

    return [(int(i), int(matched[i])) for i in np.where(matched >= 0)[0]]


def radius_best_match(
    dist_row: np.ndarray,
    candidate_mask: np.ndarray,
    octaves: np.ndarray,
) -> Tuple[int, int, int, int, int]:
    """Best and second-best among a candidate set, with their octaves.

    Shared inner pattern of ``searchByProjection``
    (keyframe_matcher.cpp:349-378): returns
    (best_idx, best_dist, best_level, second_dist, second_level).
    """
    js = np.where(candidate_mask)[0]
    best_idx, best_d, best_l = -1, 256, -1
    second_d, second_l = 256, -1
    for j in js:
        d = int(dist_row[j])
        if d < best_d:
            second_d, second_l = best_d, best_l
            best_d, best_l = d, int(octaves[j])
            best_idx = int(j)
        elif d < second_d:
            second_d, second_l = d, int(octaves[j])
    return best_idx, best_d, best_l, second_d, second_l
