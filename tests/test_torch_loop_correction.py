"""The loop correction's map-point re-expression in the port
(``pipeline/loop_closer.reexpress_map_points``): every map point moves with
its reference keyframe's correction, except a track's point that was never
triangulated, which stays at the origin, where the global BA leaves it out.

On the EuRoC-class room (``tools/torch_run_euroc_synthetic.py``, 240
frames, sigma 0.004) the JAX package's re-expression moves over a thousand
such points to the correction's translation, about 0.1 m from the origin,
behind or inside the cameras that observe them, where they dominate the
global BA's cost (``tools/trace_euroc_ba.py --package jax`` counts them).
The rule is ``pipeline/bundle_adjustment.never_triangulated``."""
import numpy as np
import pytest

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.ids import KfId, KpId, MpId
from slam_tpu_torch.map.keyframe import Keyframe
from slam_tpu_torch.map.map_point import MapPoint, MapPointStatus
from slam_tpu_torch.map.mapdb import MapDB
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.pipeline.bundle_adjustment import never_triangulated
from slam_tpu_torch.pipeline.loop_closer import reexpress_map_points


def _map():
    """Two keyframes; map point 0 triangulated, 1 whose retriangulation
    failed (it keeps a position), 2 a track's point never triangulated."""
    db = MapDB()
    rng = np.random.default_rng(0)
    for k in range(2):
        kf = Keyframe()
        kf.id = KfId(k)
        kf.map_points = np.full(3, -1, np.int64)
        kf.shared.pts = np.full((3, 2), 100.0, np.float32)
        kf.shared.octave = np.zeros(3, np.int32)
        kf.shared.descriptors = rng.integers(0, 2 ** 32, (3, 8),
                                             dtype=np.uint32)
        kf.pose_cw = se3.se3_exp(np.array([0.0, 0.1 * k, 0.0,
                                           0.3 * k, 0.0, 0.0]))
        db.keyframes[kf.id] = kf
    db.keyframes[KfId(1)].previous_kf_id = KfId(0)
    for m, status, pos in ((0, MapPointStatus.TRIANGULATED, [0.5, 0.2, 4.0]),
                           (1, MapPointStatus.NOT_TRIANGULATED,
                            [-0.4, 0.1, 3.0]),
                           (2, MapPointStatus.NOT_TRIANGULATED, [0, 0, 0])):
        mp = MapPoint(MpId(m))
        for k in range(2):
            mp.add_observation(KfId(k), KpId(m))
            db.keyframes[KfId(k)].add_observation(mp.id, KpId(m))
        mp.status = status
        mp.position = np.array(pos, np.float64)
        db.map_points[mp.id] = mp
    return db


def test_reexpression_keeps_never_triangulated_points_at_the_origin():
    db = _map()
    prev = {k: kf.pose_cw.copy() for k, kf in db.keyframes.items()}
    correction = se3.se3_exp(np.array([0.0, 0.05, 0.0, 0.2, -0.1, 0.3]))
    db.keyframes[KfId(1)].pose_cw = prev[KfId(1)] @ correction
    before = {m: mp.position.copy() for m, mp in db.map_points.items()}
    reexpress_map_points(db, {MpId(m): KfId(1) for m in range(3)}, prev,
                         StaticSettings())
    move = se3.Sim3.from_se3(db.keyframes[KfId(1)].pose_cw).inverse() \
        * se3.Sim3.from_se3(prev[KfId(1)])
    for m in (0, 1):
        np.testing.assert_allclose(db.map_points[MpId(m)].position,
                                   move.map(before[MpId(m)]), atol=1e-12)
        assert np.linalg.norm(db.map_points[MpId(m)].position
                              - before[MpId(m)]) > 0.1
    # the JAX package's re-expression would put it at the correction's
    # translation
    assert np.linalg.norm(move.map(np.zeros(3))) > 0.1
    np.testing.assert_array_equal(db.map_points[MpId(2)].position,
                                  np.zeros(3))


@pytest.mark.parametrize("m, never", [(0, False), (1, False), (2, True)])
def test_never_triangulated_is_status_and_origin(m, never):
    """Only a NOT_TRIANGULATED point at the origin counts; one whose
    retriangulation failed keeps its position and still counts as seen."""
    assert never_triangulated(_map().map_points[MpId(m)]) is never
