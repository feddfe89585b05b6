"""Typed integer ids for keyframes, map points, keypoints, tracks and maps.

TPU-native rebuild of the reference's newtype id scheme (reference:
id.hpp:14-76). We use plain ``int`` subclasses so ids remain hashable,
orderable and cheap, while still being type-distinguishable and
self-documenting. ``-1`` encodes "none", as in the reference.

The reference's ``VertexIdConverter`` (id.hpp:99-111) packs keyframe/map-point
ids into disjoint g2o vertex-id ranges; our bundle adjustment indexes dense
padded arrays instead, so no converter is needed — the packing concept
survives as the (kf_index, mp_index) slot maps built by `ops/ba.py`.
"""
from __future__ import annotations


class _Id(int):
    """Integer id with a distinct type; -1 means 'none'."""

    def __repr__(self):
        return f"{type(self).__name__}({int(self)})"

    @property
    def valid(self) -> bool:
        return int(self) >= 0


class KfId(_Id):
    """Keyframe id (equals the odometry frame number of the keyframe)."""


class MpId(_Id):
    """Map point id."""


class KpId(_Id):
    """Keypoint index within one keyframe."""


class TrackId(_Id):
    """Odometry feature-track id."""


class MapId(_Id):
    """Atlas map id."""


NO_KF = KfId(-1)
NO_MP = MpId(-1)
NO_TRACK = TrackId(-1)

# Id of the currently-built map, as opposed to read-only atlas maps
# (reference: id.hpp:76).
CURRENT_MAP_ID = MapId(1000)
