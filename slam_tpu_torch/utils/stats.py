"""Pipeline statistics counters.

Rebuild of ``BaStats`` (reference: ba_stats.hpp:9-84) and ``LoopCloserStats``
(reference: loop_closer_stats.hpp:7-116): per-frame and cumulative counts of
bundle-adjustment kinds and loop-closure outcomes, printable as tables.
"""
from __future__ import annotations

import enum
from collections import Counter
from typing import Optional


class Ba(enum.Enum):
    """reference: ba_stats.hpp (NONE, POSE, NEIGHBOR, LOCAL, GLOBAL)"""
    NONE = "none"
    POSE = "pose"
    NEIGHBOR = "neighbor"
    LOCAL = "local"
    GLOBAL = "global"


class BaStats:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.frame_kind = Ba.NONE
        self.totals: Counter = Counter()
        self.frames = 0

    def update(self, kind: Ba) -> None:
        # keep the heaviest kind for the frame (reference keeps last update;
        # call order makes that the heaviest)
        self.frame_kind = kind

    def finish_frame(self) -> None:
        self.totals[self.frame_kind] += 1
        self.frames += 1
        if self.enabled:
            print(self.table())
        self.frame_kind = Ba.NONE

    def table(self) -> str:
        rows = [f"BA stats after {self.frames} frames:"]
        for kind in Ba:
            rows.append(f"  {kind.value:<9} {self.totals[kind]}")
        return "\n".join(rows)


class Loop(enum.Enum):
    """reference: loop_closer_stats.hpp outcome taxonomy"""
    OK = "ok"
    TOO_CLOSE_TIME = "too_close_time"
    UNNECESSARY_EARLY = "unnecessary_early"
    UNNECESSARY = "unnecessary"
    TOO_FEW_FEATURE_MATCHES = "too_few_feature_matches"
    RANSAC_FAILED = "ransac_failed"
    TOO_LARGE_POSITION_DRIFT = "too_large_position_drift"
    TOO_LARGE_ANGLE_DRIFT = "too_large_angle_drift"
    UNKNOWN = "unknown"


class LoopCloserStats:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.totals: Counter = Counter()
        self._loop_open = False

    def new_loop(self) -> None:
        if self._loop_open:
            self.totals[Loop.UNKNOWN] += 1
        self._loop_open = True

    def update(self, outcome: Loop) -> None:
        self.totals[outcome] += 1
        self._loop_open = False

    def finish_frame(self) -> None:
        if self._loop_open:
            self.totals[Loop.UNKNOWN] += 1
            self._loop_open = False
        if self.enabled:
            print(self.table())

    def table(self) -> str:
        rows = ["Loop closer stats:"]
        for kind in Loop:
            rows.append(f"  {kind.value:<26} {self.totals[kind]}")
        return "\n".join(rows)
