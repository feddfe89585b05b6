"""Standalone feature tracker: frame-to-frame ORB descriptor chaining.

The reference is a backend module fed by an external LK tracker (SURVEY.md
§1 L0: `tracker::FeatureDetector`, MapperInput.trackerFeatures). This module
provides a self-contained substitute so the framework runs standalone on raw
image streams: ORB features from the front-end are matched frame-to-frame
(Hamming + Lowe ratio + symmetry + motion gate) and chained into persistent
tracks with fresh ids per acquisition episode — the same contract the host
tracker provides. The front-end runs on the device given to the tracker
(the card unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from slam_tpu_torch.ops.frontend import FrontendResult, OrbExtractor
from slam_tpu_torch.params import StaticSettings


@dataclasses.dataclass
class TrackedFrame:
    features: FrontendResult       # compacted front-end output
    track_ids: np.ndarray          # (N,) int64 track id per keypoint (-1 none)
    tracked_pts: np.ndarray        # (K, 2) positions of live tracks
    tracked_id_list: np.ndarray    # (K,) their ids


class DescriptorTracker:
    def __init__(self, settings: StaticSettings, width: int, height: int,
                 max_tracks: int = 128, match_threshold: int = 50,
                 lowe_ratio: float = 0.8, max_motion_px: float = 80.0,
                 device="cuda"):
        self.extractor = OrbExtractor(settings, width, height,
                                      max_tracked=max_tracks, device=device)
        self.max_tracks = max_tracks
        self.match_threshold = match_threshold
        self.lowe_ratio = lowe_ratio
        self.max_motion_px = max_motion_px
        self._next_id = 0
        self._prev: Optional[FrontendResult] = None
        self._prev_track_ids: Optional[np.ndarray] = None

    def process(self, image: np.ndarray) -> TrackedFrame:
        # run the front-end with the previous tracked positions as the
        # LK-slot hints (keeps the slot layout contract of the reference).
        # As in the reference, t_pts/t_ids are computed but not passed to
        # detect_and_extract: every keypoint comes from detection.
        if self._prev is not None:
            live = self._prev_track_ids >= 0
            t_pts = self._prev.pts[live][:self.max_tracks]
            t_ids = self._prev_track_ids[live][:self.max_tracks]
        else:
            t_pts = np.zeros((0, 2), np.float32)
            t_ids = np.zeros(0, np.int64)
        res = self.extractor.detect_and_extract(image).compact()

        n = len(res.pts)
        track_ids = np.full(n, -1, np.int64)
        if self._prev is not None and n and len(self._prev.pts):
            track_ids = self._match_to_prev(res)
        # start new tracks on strong unmatched keypoints
        live_count = int((track_ids >= 0).sum())
        for i in range(n):
            if live_count >= self.max_tracks:
                break
            if track_ids[i] < 0:
                track_ids[i] = self._next_id
                self._next_id += 1
                live_count += 1

        self._prev = res
        self._prev_track_ids = track_ids
        live = track_ids >= 0
        return TrackedFrame(features=res, track_ids=track_ids,
                            tracked_pts=res.pts[live],
                            tracked_id_list=track_ids[live])

    def _match_to_prev(self, res: FrontendResult) -> np.ndarray:
        from slam_tpu_torch import native

        prev = self._prev
        best_j = native.match_tracker(
            res.descriptors, res.pts, prev.descriptors, prev.pts,
            self.max_motion_px, self.match_threshold, self.lowe_ratio)
        if best_j is None:
            best_j = self._match_to_prev_numpy(
                res.descriptors, res.pts, prev.descriptors, prev.pts)
        return self._carry_ids(best_j)

    def _match_to_prev_numpy(self, desc_cur, pts_cur, desc_prev,
                             pts_prev) -> np.ndarray:
        """Semantics reference for native.match_tracker (kept in lockstep;
        cross-checked in tests/test_native_and_misc.py). Returns (N,) int64
        previous-frame index per current keypoint, -1 for no match."""
        from slam_tpu_torch import native

        n = len(pts_cur)
        dist = native.hamming_matrix(desc_cur, desc_prev)
        # motion gate: matches farther than max_motion_px are implausible
        d2 = np.sum((pts_cur[:, None, :] - pts_prev[None, :, :]) ** 2,
                    axis=-1)
        dist = np.where(d2 <= self.max_motion_px ** 2, dist, 10_000)

        # stable: on distance ties the lowest index wins, matching the
        # native op's strict '<' first-minimum scan
        order = np.argsort(dist, axis=1, kind="stable")[:, :2]
        best_j = order[:, 0]
        best = dist[np.arange(n), best_j]
        second = (dist[np.arange(n), order[:, 1]]
                  if dist.shape[1] > 1 else np.full(n, 256))
        ok = (best <= self.match_threshold) & (best < self.lowe_ratio * second)
        # symmetry: previous keypoint must also prefer this one
        back = np.argmin(dist, axis=0)
        ok &= back[best_j] == np.arange(n)
        return np.where(ok, best_j, -1).astype(np.int64)

    def _carry_ids(self, best_j: np.ndarray) -> np.ndarray:
        """Carry track ids one-to-one, first-wins over current index."""
        prev_ids = self._prev_track_ids
        track_ids = np.full(len(best_j), -1, np.int64)
        used = set()
        for i in np.where(best_j >= 0)[0]:
            tid = int(prev_ids[best_j[i]])
            if tid >= 0 and tid not in used:
                track_ids[i] = tid
                used.add(tid)
        return track_ids
