"""ASCII keyframe-set visualization for terminal debugging.

Rebuild of ``asciiKeyframes`` (reference: keyframe.cpp:379-397): prints one
character per keyframe id slot, newest at the right edge, using a caller
status function — used to eyeball the adjacency set (mapper_helpers.cpp:
218-226, flag ``kfAsciiAdjacent``) and local-BA membership
(bundle_adjuster.cpp:225-233, flag ``kfAsciiBA``).
"""
from __future__ import annotations

from typing import Callable

from slam_tpu_torch.ids import KfId


def ascii_keyframes(status: Callable[[KfId], str], map_db, length: int) -> str:
    """Render the keyframe status line; returns the string (and prints it)."""
    if not map_db.keyframes:
        return ""
    last_id = int(max(map_db.keyframes))
    line = [" "] * length
    last_rev = 0
    rev = length - 1
    for ind in range(last_id + 1):
        if last_id - ind < 0 or rev < 0:
            break
        kf_id = KfId(last_id - ind)
        if kf_id not in map_db.keyframes:
            continue
        line[rev] = status(kf_id)
        last_rev = rev
        rev -= 1
    if last_rev > 0 and line[last_rev] == " ":
        line[last_rev] = "0"
    out = "".join(line)
    print(out)
    return out
