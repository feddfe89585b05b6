"""Radius search over a keyframe's keypoints.

Rebuild of the reference ``FeatureSearch`` (reference: feature_search.cpp:
8-49): keypoints indexed by y coordinate, binary search for the y band, then
an exact strict circle test (dx^2 + dy^2 < r^2). Vectorized with NumPy; also
offers a batched all-queries variant used by the projection matchers.
"""
from __future__ import annotations

from typing import List

import numpy as np


class FeatureSearch:
    def __init__(self, pts: np.ndarray):
        """pts: (N, 2) keypoint pixel positions."""
        self.pts = np.asarray(pts, dtype=np.float32).reshape(-1, 2)
        self._order = np.argsort(self.pts[:, 1], kind="stable")
        self._ys = self.pts[self._order, 1]
        self._xs = self.pts[self._order, 0]

    def get_features_around(self, x: float, y: float, r: float) -> np.ndarray:
        """Indices of keypoints strictly inside the circle, in y order
        (matching the reference's output order)."""
        from slam_tpu_torch import native
        hits = native.radius_search(self._xs, self._ys, x, y, r)
        return self._order[hits]

    def query_many(self, centers: np.ndarray, radii: np.ndarray) -> List[np.ndarray]:
        """Batched version: one call per projected map point."""
        centers = np.asarray(centers, dtype=np.float32).reshape(-1, 2)
        radii = np.asarray(radii, dtype=np.float32).reshape(-1)
        return [self.get_features_around(c[0], c[1], r)
                for c, r in zip(centers, radii)]
