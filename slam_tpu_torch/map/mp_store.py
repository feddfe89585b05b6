"""Columnar mirror of live map-point attributes.

The reference holds map points as C++ objects and its hot per-keyframe loops
walk them at native speed (mapper_helpers.cpp:231-373, keyframe_matcher.cpp:
416-529, bundle_adjuster.cpp:259-291). The Python rebuild keeps `MapPoint`
objects as the source of truth for fidelity, but a per-object Python
attribute walk in every pipeline stage is the host bottleneck on the frame
critical path. This store keeps dense NumPy columns of the scalar attributes
of every map point REGISTERED in one ``MapDB``, maintained write-through by
``MapPoint.__setattr__`` and the observation bookkeeping hooks, so each stage
reads one vectorized gather instead of looping objects.

Rows are recycled through a free list; ``id2row`` translates map-point id
values (sequential, per-map) to rows. Consumers must treat the columns as a
snapshot between mutations — the pipeline's per-row "mutable state" rechecks
(e.g. ``replace_duplication``) remain authoritative.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

_GROW = 2


class MpStore:
    # attribute name -> column dtype/shape (scalar attrs mirrored by
    # MapPoint.__setattr__; observation-derived columns maintained by the
    # add/erase/set observation hooks)
    MIRRORED = ("status", "position", "norm", "min_viewing_distance",
                "max_viewing_distance", "descriptor")

    def __init__(self, cap: int = 512):
        self._alloc(cap)
        self.n = 0                    # high-water mark (rows < n are defined)
        self.free: List[int] = []
        self.id2row = np.full(1024, -1, np.int64)
        self.objs: List[Optional[object]] = [None] * cap
        # incremental covisibility: covis[a][b] = number of registered map
        # points observed by keyframes a AND b, maintained by the observation
        # hooks + adopt/release. Keyframe.get_neighbors reads this instead of
        # re-counting every observation dict per call (keyframe.cpp:192-230
        # semantics; audited against a recount in check_consistency).
        self.covis: Dict[object, Counter] = {}

    def _alloc(self, cap: int) -> None:
        self.cap = cap
        self.status = np.zeros(cap, np.int8)
        self.position = np.zeros((cap, 3))
        self.norm = np.zeros((cap, 3), np.float32)
        self.min_viewing_distance = np.zeros(cap)
        self.max_viewing_distance = np.zeros(cap)
        self.descriptor = np.zeros((cap, 8), np.uint32)
        self.n_obs = np.zeros(cap, np.int32)
        self.first_kf = np.full(cap, -1, np.int64)

    def _grow(self) -> None:
        old = (self.status, self.position, self.norm,
               self.min_viewing_distance, self.max_viewing_distance,
               self.descriptor, self.n_obs, self.first_kf)
        n = self.cap
        self.objs.extend([None] * (self.cap * (_GROW - 1)))
        self._alloc(self.cap * _GROW)
        (self.status[:n], self.position[:n], self.norm[:n],
         self.min_viewing_distance[:n], self.max_viewing_distance[:n],
         self.descriptor[:n], self.n_obs[:n], self.first_kf[:n]) = old

    # ------------------------------------------------------------------

    def covis_link(self, kf_id, others) -> None:
        """One map point became co-observed by ``kf_id`` and each of
        ``others``: bump the pair counts symmetrically."""
        cv = self.covis
        mine = cv.get(kf_id)
        if mine is None:
            mine = cv[kf_id] = Counter()
        for other in others:
            mine[other] += 1
            co = cv.get(other)
            if co is None:
                co = cv[other] = Counter()
            co[kf_id] += 1

    def covis_unlink(self, kf_id, others) -> None:
        """Reverse of ``covis_link`` (zero entries are deleted)."""
        cv = self.covis
        mine = cv.get(kf_id)
        for other in others:
            v = mine[other] - 1
            if v:
                mine[other] = v
            else:
                del mine[other]
            co = cv[other]
            v = co[kf_id] - 1
            if v:
                co[kf_id] = v
            else:
                del co[kf_id]

    # ------------------------------------------------------------------

    def adopt(self, mp) -> None:
        """Register a map point: allocate a row and snapshot its state."""
        mp_id = int(mp.id)
        if mp_id >= len(self.id2row):
            new = np.full(max(len(self.id2row) * _GROW, mp_id + 1), -1,
                          np.int64)
            new[:len(self.id2row)] = self.id2row
            self.id2row = new
        if self.free:
            row = self.free.pop()
        else:
            if self.n == self.cap:
                self._grow()
            row = self.n
            self.n += 1
        self.id2row[mp_id] = row
        self.objs[row] = mp
        object.__setattr__(mp, "_row", row)
        self.status[row] = int(mp.status)
        self.position[row] = mp.position
        self.norm[row] = mp.norm
        self.min_viewing_distance[row] = mp.min_viewing_distance
        self.max_viewing_distance[row] = mp.max_viewing_distance
        self.descriptor[row] = mp.descriptor
        self.n_obs[row] = len(mp.observations)
        self.first_kf[row] = (int(min(mp.observations))
                              if mp.observations else -1)
        keys = list(mp.observations)
        for i in range(1, len(keys)):
            self.covis_link(keys[i], keys[:i])
        object.__setattr__(mp, "_store", self)

    def release(self, mp) -> None:
        """Unregister a map point, freeing its row."""
        row = mp._row
        self.id2row[int(mp.id)] = -1
        self.objs[row] = None
        self.free.append(row)
        keys = list(mp.observations)
        for i in range(1, len(keys)):
            self.covis_unlink(keys[i], keys[:i])
        object.__setattr__(mp, "_store", None)
        object.__setattr__(mp, "_row", -1)

    # ------------------------------------------------------------------

    def rows_of(self, vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, live) for an int array of map-point id values; ``live`` is
        False (row 0 substituted) for ids not currently registered."""
        vals = np.asarray(vals, np.int64)
        in_range = (vals >= 0) & (vals < len(self.id2row))
        rows = np.where(in_range, self.id2row[np.where(in_range, vals, 0)], -1)
        live = rows >= 0
        return np.where(live, rows, 0), live

    def live_rows(self) -> np.ndarray:
        """Rows of every registered map point (unordered)."""
        rows = np.flatnonzero(self.id2row >= 0)
        return self.id2row[rows]
