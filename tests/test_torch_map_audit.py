"""The map audit, ``check_consistency``, on small hand-built maps.

Its covisibility check compares the incremental pair counts of
``map/mp_store`` with a recount. The JAX package's recount makes an empty
count for every keyframe a map point names, while the cache drops a count
when it reaches zero, so the JAX audit fails on a sound map with a
keyframe that shares no map point with any other. An interactive session
reaches such a map when the local BA's outlier pruning and then map-point
culling take every shared point of an old keyframe, leaving it a point
that it alone observes. The port's audit drops empty counts on both
sides; it must still catch a cache that is really out of sync."""
import numpy as np
import pytest

from slam_tpu.ids import KfId as JKfId, KpId as JKpId, MpId as JMpId
from slam_tpu.map.keyframe import Keyframe as JKeyframe
from slam_tpu.map.map_point import MapPoint as JMapPoint
from slam_tpu.map.mapdb import MapDB as JMapDB
from slam_tpu.pipeline.mapper_helpers import (
    check_consistency as jcheck_consistency)
from slam_tpu_torch.ids import KfId, KpId, MpId
from slam_tpu_torch.map.keyframe import Keyframe
from slam_tpu_torch.map.map_point import MapPoint
from slam_tpu_torch.map.mapdb import MapDB
from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

TORCH = (KfId, KpId, MpId, Keyframe, MapPoint, MapDB)
JAX = (JKfId, JKpId, JMpId, JKeyframe, JMapPoint, JMapDB)


def _chain_map(classes, n_kf=3, n_kp=4):
    """Keyframes 0..n_kf-1 chained prev/next, each with ``n_kp`` keypoints;
    map point 0 seen by keyframes 0 and 1 at keypoint 0, map point 1 by 1
    and 2 at keypoint 1, map point 2 by keyframe 2 alone at keypoint 2."""
    KfId_, KpId_, MpId_, Keyframe_, MapPoint_, MapDB_ = classes
    db = MapDB_()
    for k in range(n_kf):
        kf = Keyframe_()
        kf.id = KfId_(k)
        kf.map_points = np.full(n_kp, -1, np.int64)
        if k > 0:
            kf.previous_kf_id = KfId_(k - 1)
            db.keyframes[KfId_(k - 1)].next_kf_id = kf.id
        db.keyframes[kf.id] = kf
    for m, kfs in enumerate(([0, 1], [1, 2], [2])):
        mp = MapPoint_(MpId_(m))
        for k in kfs:
            mp.add_observation(KfId_(k), KpId_(m))
            db.keyframes[KfId_(k)].add_observation(mp.id, KpId_(m))
        db.map_points[mp.id] = mp
    return db


def _prune(classes, db, mp_val, kf_val):
    """Cut one observation as the local BA's outlier pruning does
    (``PendingLocalBA``/``prune_outliers``: map point side, then keyframe
    side)."""
    KfId_, _, MpId_ = classes[:3]
    db.map_points[MpId_(mp_val)].erase_observation(KfId_(kf_val))
    db.keyframes[KfId_(kf_val)].erase_observation(MpId_(mp_val))


@pytest.mark.parametrize("kf_alone", [0, 2])
def test_audit_passes_with_a_keyframe_that_shares_no_point(kf_alone):
    """Pruning leaves keyframe ``kf_alone`` with map points it alone sees:
    the map is sound, and the port's audit passes where the JAX package's
    raises."""
    maps = {}
    for name, classes in (("port", TORCH), ("jax", JAX)):
        db = _chain_map(classes)
        if kf_alone == 0:
            _prune(classes, db, 0, 1)
        else:
            _prune(classes, db, 1, 1)
        maps[name] = db
    check_consistency(maps["port"])
    alone = KfId(kf_alone)
    assert not maps["port"].mp_store.covis.get(alone)
    with pytest.raises(AssertionError, match="covisibility cache"):
        jcheck_consistency(maps["jax"])


@pytest.mark.parametrize("fault", ["count", "pair", "kf"])
def test_audit_catches_a_cache_out_of_sync(fault):
    """A wrong count, a pair that no map point holds, or a count for a
    keyframe that shares nothing still fails the port's audit."""
    db = _chain_map(TORCH)
    check_consistency(db)
    covis = db.mp_store.covis
    if fault == "count":
        covis[KfId(0)][KfId(1)] += 1
    elif fault == "pair":
        covis[KfId(0)][KfId(2)] += 1
        covis[KfId(2)][KfId(0)] += 1
    else:
        _prune(TORCH, db, 1, 1)            # keyframe 2 now shares nothing
        covis[KfId(2)][KfId(1)] = 1
    with pytest.raises(AssertionError, match="covisibility cache"):
        check_consistency(db)
