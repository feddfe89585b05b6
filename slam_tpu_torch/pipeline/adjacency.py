"""Spatially-defined keyframe adjacency.

Rebuild of ``computeAdjacentKeyframes`` (reference: mapper_helpers.cpp:
144-229): walk the prev/next keyframe chain from the current keyframe,
collect covisibility neighbors ("parents") every second step, extend chains
around each parent, then keep the N spatially closest keyframes.
"""
from __future__ import annotations

from typing import List

import numpy as np

from slam_tpu_torch.ids import KfId
from slam_tpu_torch.map.keyframe import Keyframe
from slam_tpu_torch.map.mapdb import MapDB
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.utils.timer import timed


@timed
def compute_adjacent_keyframes(current_keyframe: Keyframe,
                               min_covisibilities: int,
                               max_keyframes: int,
                               map_db: MapDB,
                               settings: StaticSettings,
                               visualize: bool = False) -> List[KfId]:
    adjacent_set = set()
    parents = set()

    # walk backwards along the prev chain (mapper_helpers.cpp:160-176)
    i = 0
    backwards = current_keyframe.id
    while backwards.valid:
        adjacent_set.add(backwards)
        keyframe = map_db.keyframes[backwards]
        if i % 2 == 0:
            parents.update(keyframe.get_neighbors(map_db, min_covisibilities, False))
        i += 1
        if i >= max_keyframes:
            break
        backwards = keyframe.previous_kf_id

    # chains around each parent (mapper_helpers.cpp:179-200)
    for parent in sorted(parents):
        backwards = parent
        i = 0
        while backwards.valid:
            adjacent_set.add(backwards)
            i += 1
            if i >= max_keyframes // 2:
                break
            backwards = map_db.keyframes[backwards].previous_kf_id
        forwards = parent
        i = 0
        while forwards.valid:
            adjacent_set.add(forwards)
            i += 1
            if i >= max_keyframes // 2:
                break
            forwards = map_db.keyframes[forwards].next_kf_id

    adjacent_set.discard(current_keyframe.id)
    adjacent = sorted(adjacent_set)

    # keep the N closest by camera-center distance (mapper_helpers.cpp:206-216)
    # — one stacked distance computation + stable argsort (ties keep
    # ascending-id order, identical to the stable key sort)
    current_pos = current_keyframe.camera_center()
    if adjacent:
        centers = np.stack([map_db.keyframes[k].camera_center()
                            for k in adjacent])
        d2 = np.sum((centers - current_pos) ** 2, axis=1)
        order = np.argsort(d2, kind="stable")[:max_keyframes]
        adjacent = [adjacent[int(i)] for i in order]

    if visualize and settings.parameters.slam.kfAsciiAdjacent:
        # reference: mapper_helpers.cpp:218-226
        from slam_tpu_torch.utils.ascii_viz import ascii_keyframes
        adj = set(adjacent)
        ascii_keyframes(lambda k: "a" if k in adj else " ", map_db,
                        settings.parameters.slam.kfAsciiWidth)
    return adjacent
