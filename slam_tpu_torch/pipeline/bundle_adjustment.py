"""Bundle-adjustment drivers: build problems from the map, run the device
solver (port of slam_tpu/pipeline/bundle_adjustment.py).

Rebuild of the reference's three g2o solvers (reference: bundle_adjuster.cpp):

  - ``local_bundle_adjust`` (141-394): adjacency + forced-6-newest island,
    two-stage optimize (current-KF-only, then all-free with a soft
    orientation anchor), chi2 observation pruning;
  - ``pose_bundle_adjust`` (396-491): current KF against fixed previous KF
    and fixed map points;
  - ``global_bundle_adjust`` (493-604): whole map, current KF fixed.

Problems are padded with the JAX package's quanta (K 16, M 256, O 1024,
E 32, P 1), because ``ops/ba.pick_cg_iters`` chooses the dense-Schur or the
PCG solver from the padded sizes; what a padded slot holds is
``ops/ba.PADDING``, the rule a covering bucket pads a smaller problem by.
Each solve runs on the device carried by the ``WorkspaceBA`` (or given to
``pose_bundle_adjust``/``global_bundle_adjust``): the problem goes over
pinned host memory, the result comes back into pinned buffers behind the
solve, and a CUDA event recorded after that copy is all a collector waits
on. The local and pose BAs run as one program per padded bucket
(``ops/ba.solve_ba_two_stage``, ``solve_ba``: on a card a replayed CUDA
graph, the problem copied from pinned memory straight into the bucket's
buffers, or into a larger bucket's that covers it); the global BA runs op
by op (``ops/ba.solve_ba_eager``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from slam_tpu_torch.ids import KfId, KpId, MpId
from slam_tpu_torch.map.keyframe import Keyframe
from slam_tpu_torch.map.map_point import MapPoint, MapPointStatus
from slam_tpu_torch.map.mapdb import MapDB
from slam_tpu_torch.ops import ba
from slam_tpu_torch.params import StaticSettings
from slam_tpu_torch.pipeline.adjacency import compute_adjacent_keyframes
from slam_tpu_torch.utils.stats import Ba, BaStats
from slam_tpu_torch.utils import timer
from slam_tpu_torch.utils.timer import section, timed

CHI2_THRESHOLD = ba.CHI2_THRESHOLD


@dataclasses.dataclass
class PendingLocalBA:
    """An in-flight deferred local-BA solve (``pipelinedLocalBA`` mode).

    Holds the in-flight result plus everything the apply + pipeline tail
    needs when it is collected at the next finalize point."""
    device_result: "_InFlight"     # solve enqueued, host copy behind it
    builder: "_ProblemBuilder"
    kf_id: KfId
    adjacent_kf_ids: List[KfId]
    kind: Ba                       # Ba.LOCAL (prune+apply all) or Ba.NEIGHBOR


@dataclasses.dataclass
class WorkspaceBA:
    """reference: bundle_adjuster.hpp:16-25. ``device`` is where its
    solves run."""
    local_kf_ids: Set[KfId] = dataclasses.field(default_factory=set)
    local_mp_ids: Set[MpId] = dataclasses.field(default_factory=set)
    ba_stats: BaStats = dataclasses.field(default_factory=BaStats)
    pending: Optional[PendingLocalBA] = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cuda"))

    def __post_init__(self):
        self.device = torch.device(self.device)


def odometry_prior_strengths(kf_id1: KfId, kf_id2: KfId,
                             parameters, map_db: MapDB) -> np.ndarray:
    """6x6 information for the odometry edge between consecutive keyframes
    (reference: mapper_helpers.cpp:911-956). Rotation block first."""
    p = parameters.odometryPriorStrengthPosition
    r = parameters.odometryPriorStrengthRotation
    info = np.eye(6)
    assert int(kf_id2) > int(kf_id1)
    kf1 = map_db.keyframes[kf_id1]
    kf2 = map_db.keyframes[kf_id2]
    dt = max(kf2.t - kf1.t, 1e-6)
    s = 0.26667 / dt
    if parameters.odometryPriorFixed:
        info[:3, :3] *= s * r * r
    else:
        info[:3, :3] = r * r / 135000.0 * np.linalg.inv(kf2.uncertainty[:3, :3])
    if parameters.odometryPriorFixed:
        info[3:, 3:] *= s * p * p
    elif parameters.odometryPriorSimpleUncertainty:
        mean_unc = np.mean([1.0 / max(np.linalg.norm(kf2.uncertainty[i]), 1e-9)
                            for i in range(3)])
        info[3:, 3:] *= p * p / 5000.0 * mean_unc
    else:
        info[3:, 3:] = p * p / 5000.0 * np.linalg.inv(kf2.uncertainty[:, 3:])
    return info


def loop_edge_information(parameters) -> np.ndarray:
    """Distance-independent loop-closure edge information
    (reference: bundle_adjuster.cpp:103-109)."""
    p = parameters.odometryPriorStrengthPosition
    r = parameters.odometryPriorStrengthRotation
    info = np.eye(6)
    info[:3, :3] *= r * r
    info[3:, 3:] *= p * p
    return info


def _sqrt_info(info: np.ndarray) -> np.ndarray:
    """Whitening factor S with S^T S = info (use L^T from info = L L^T)."""
    d = np.diagonal(info)
    if not (info - np.diag(d)).any():
        # diagonal info (odometry priors, loop edges, anchors): exact sqrt
        # without the eigendecomposition that dominated edge addition
        return np.diag(np.sqrt(np.clip(d, 0.0, None)))
    # tolerate rank-deficient info (e.g. rotation-only anchors)
    w, V = np.linalg.eigh((info + info.T) / 2.0)
    w = np.clip(w, 0.0, None)
    return (V * np.sqrt(w)[None, :]) @ V.T


def _pad(n: int, quantum: int) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def _staged(arrays, device: torch.device):
    """NumPy arrays -> host tensors with a leading batch axis of 1, integer
    index arrays as int64; in pinned memory when ``device`` is a card, so
    that their copy to it does not block the host."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(a[None]))
        out.append(t.pin_memory() if device.type == "cuda" else t)
    return out


def _problem_to_device(problem: ba.BAProblem, device: torch.device
                       ) -> ba.BAProblem:
    return ba.BAProblem(*(t.to(device, non_blocking=True)
                          for t in _staged(problem, device)))


class _InFlight:
    """A solve enqueued on the device's current stream, with its result
    copied into pinned host buffers behind it and an event after the copy.
    ``get`` waits on that event only and returns the NumPy ``BAResult``
    without the batch axis; while timing is on, it adds the solve's graph
    replay's device time to the timer as ``ba.replay_device``."""

    def __init__(self, result: ba.BAResult):
        dev = result.poses.device
        self._replay = ba.BA_GRAPHS.take_replay_events()
        if dev.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in result]
            for h, t in zip(self._host, result):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host, self._event = list(result), None

    def get(self) -> ba.BAResult:
        if self._event is not None:
            self._event.synchronize()
        if self._replay is not None:
            start, end = self._replay
            self._replay = None
            timer.add_device("ba.replay_device",
                             1e-3 * start.elapsed_time(end))
        return ba.BAResult(*(t[0].numpy() for t in self._host))


class _ProblemBuilder:
    """Accumulates vertices/edges, pads, solves, writes back."""

    def __init__(self, settings: StaticSettings, device):
        self.settings = settings
        self.device = torch.device(device)
        self.kf_ids: List[KfId] = []
        self.kf_slot: Dict[KfId, int] = {}
        self.mp_ids: List[MpId] = []
        self.mp_slot: Dict[MpId, int] = {}
        self.poses: List[np.ndarray] = []
        self.pose_fixed: List[bool] = []
        self.points: List[np.ndarray] = []
        self.points_fixed: List[bool] = []
        # columnar observation chunks: (kf_slot, mp_slots, meas, sqrt_info)
        self.obs_chunks: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        self.n_obs = 0
        self.obs_tag: List[Tuple[KfId, MpId]] = []
        self.pe: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        self.priors: List[Tuple[int, np.ndarray, np.ndarray]] = []

    def add_keyframe(self, kf: Keyframe, fixed: bool) -> int:
        slot = self.kf_slot.get(kf.id)
        if slot is None:
            slot = len(self.kf_ids)
            self.kf_slot[kf.id] = slot
            self.kf_ids.append(kf.id)
            self.poses.append(np.asarray(kf.pose_cw, np.float64))
            self.pose_fixed.append(fixed)
        return slot

    def add_map_point(self, mp: MapPoint, fixed: bool) -> int:
        slot = self.mp_slot.get(mp.id)
        if slot is None:
            slot = len(self.mp_ids)
            self.mp_slot[mp.id] = slot
            self.mp_ids.append(mp.id)
            self.points.append(np.asarray(mp.position, np.float64))
            self.points_fixed.append(fixed)
        return slot

    def add_map_points_bulk(self, mps, fixed: bool = False,
                            positions: Optional[np.ndarray] = None) -> None:
        """add_map_point for a list of fresh points (none already present).

        ``positions``: optional (N, 3) array (columnar-store gather) saving
        the per-object attribute walk."""
        base = len(self.mp_ids)
        if positions is None:
            for mp in mps:
                self.mp_ids.append(mp.id)
                self.points.append(np.asarray(mp.position, np.float64))
                self.points_fixed.append(fixed)
        else:
            self.mp_ids.extend(mp.id for mp in mps)
            self.points.extend(np.asarray(positions, np.float64))
            self.points_fixed.extend([fixed] * len(mps))
        self.mp_slot.update(
            (mp.id, base + i) for i, mp in enumerate(mps))

    def add_observation(self, kf: Keyframe, kp_id: KpId, mp: MapPoint) -> None:
        """Normalized-camera measurement with focal^2/sigma^2 information
        (reference: bundle_adjuster.cpp:43-63)."""
        self.add_observations_bulk(kf, np.asarray([int(kp_id)]),
                                   np.asarray([self.mp_slot[mp.id]]), [mp.id])

    def add_observations_bulk(self, kf: Keyframe, kp_indices: np.ndarray,
                              mp_slots: np.ndarray, mp_ids) -> None:
        """Vectorized add_observation for all of one keyframe's observations
        entering the problem (same measurement/information semantics)."""
        kf_slot = self.kf_slot[kf.id]
        bearings = kf.shared.bearings[kp_indices]
        meas = (bearings[:, :2] / bearings[:, 2:3]).astype(np.float32)
        focal = float(kf.shared.camera.get_focal_length())
        si = (focal / np.sqrt(
            self.settings.levelSigmaSq[kf.shared.octave[kp_indices]])
              ).astype(np.float32)
        self.obs_chunks.append(
            (kf_slot, np.asarray(mp_slots, np.int32), meas, si))
        self.n_obs += len(kp_indices)
        kf_id = kf.id
        self.obs_tag.extend((kf_id, m) for m in mp_ids)

    def add_odometry_edge(self, kf_id: KfId, prev_kf_id: KfId, map_db: MapDB) -> None:
        """vertex0 = kf, vertex1 = prev (reference: bundle_adjuster.cpp:65-85)."""
        pose_diff = map_db.pose_difference(prev_kf_id, kf_id)
        info = odometry_prior_strengths(
            prev_kf_id, kf_id, self.settings.parameters.slam, map_db)
        self.pe.append((self.kf_slot[kf_id], self.kf_slot[prev_kf_id],
                        pose_diff, _sqrt_info(info)))

    def add_loop_edge(self, kf_id1: KfId, kf_id2: KfId, pose_diff: np.ndarray) -> bool:
        """vertex0 = kfId2, vertex1 = kfId1 (reference: bundle_adjuster.cpp:87-111)."""
        if kf_id1 not in self.kf_slot or kf_id2 not in self.kf_slot:
            return False
        info = loop_edge_information(self.settings.parameters.slam)
        self.pe.append((self.kf_slot[kf_id2], self.kf_slot[kf_id1],
                        pose_diff, _sqrt_info(info)))
        return True

    def add_orientation_anchor(self, kf_id: KfId, pose_cw: np.ndarray) -> None:
        """Soft orientation prior (reference: bundle_adjuster.cpp:339-370),
        with the weak translation gauge block documented at the two-stage
        call site in local_bundle_adjust."""
        p = self.settings.parameters.slam
        r = 100.0 * p.odometryPriorStrengthRotation
        info = np.zeros((6, 6))
        info[:3, :3] = np.eye(3) * r * r
        info[3:, 3:] = np.eye(3) * p.odometryPriorStrengthPosition ** 2
        self.priors.append((self.kf_slot[kf_id], np.asarray(pose_cw), _sqrt_info(info)))

    # ------------------------------------------------------------------

    def build(self) -> ba.BAProblem:
        """The problem as NumPy arrays padded to the quanta, each padded
        slot as ``ops/ba.PADDING`` says (the rule a covering bucket pads
        by); the solve entry points move them to the device."""
        # the reference's quanta: pick_cg_iters reads the padded sizes
        size = dict(K=_pad(len(self.kf_ids), 16),
                    M=_pad(len(self.mp_ids), 256), O=_pad(self.n_obs, 1024),
                    E=_pad(len(self.pe), 32), P=_pad(len(self.priors), 1))

        def padded(field, rows, dtype, shape=()):
            a = np.empty((size[ba.PADDING[field][0]],) + shape, dtype)
            n = len(rows)
            if n:
                a[:n] = rows
            ba.fill_padding(a[None], field, n)
            return a

        chunks, n = self.obs_chunks, self.n_obs
        obs = ([np.concatenate([c[i] for c in chunks]) for i in (1, 2, 3)]
               if n else [()] * 3)
        obs_kf = (np.repeat(np.fromiter((c[0] for c in chunks), np.int32,
                                        len(chunks)),
                            [len(c[1]) for c in chunks]) if n else ())
        pe = list(zip(*self.pe)) or [()] * 4
        pr = list(zip(*self.priors)) or [()] * 3
        return ba.BAProblem(
            poses=padded("poses", self.poses, np.float32, (4, 4)),
            pose_fixed=padded("pose_fixed", self.pose_fixed, bool),
            points=padded("points", self.points, np.float32, (3,)),
            points_fixed=padded("points_fixed", self.points_fixed, bool),
            obs_kf=padded("obs_kf", obs_kf, np.int32),
            obs_mp=padded("obs_mp", obs[0], np.int32),
            obs_meas=padded("obs_meas", obs[1], np.float32, (2,)),
            obs_sqrt_info=padded("obs_sqrt_info", obs[2], np.float32),
            obs_valid=padded("obs_valid", np.ones(n, bool), bool),
            pe_a=padded("pe_a", pe[0], np.int32),
            pe_b=padded("pe_b", pe[1], np.int32),
            pe_meas=padded("pe_meas", pe[2], np.float32, (4, 4)),
            pe_sqrt_info=padded("pe_sqrt_info", pe[3], np.float32, (6, 6)),
            pe_valid=padded("pe_valid", np.ones(len(self.pe), bool), bool),
            pr_idx=padded("pr_idx", pr[0], np.int32),
            pr_meas=padded("pr_meas", pr[1], np.float32, (4, 4)),
            pr_sqrt_info=padded("pr_sqrt_info", pr[2], np.float32, (6, 6)),
            pr_valid=padded("pr_valid", np.ones(len(self.priors), bool),
                            bool))

    def solve_async(self, iterations: int, pick=ba.pick_cg_iters,
                    eager: bool = False) -> _InFlight:
        """Enqueue the solve and its host copy; returns without waiting.
        ``pick`` chooses the solver from the padded sizes; the solve is
        ``ops/ba.solve_ba``'s program for its bucket, or with ``eager`` the
        op-by-op ``solve_ba_eager``."""
        problem = self.build()
        # the solver follows the PADDED shapes (0 = dense Schur)
        K, M = problem.poses.shape[0], problem.points.shape[0]
        cg = pick(K, M)
        if eager:
            result = ba.solve_ba_eager(
                _problem_to_device(problem, self.device),
                iterations=int(iterations), cg_iters=int(cg))
        else:
            result = ba.solve_ba(
                ba.BAProblem(*_staged(problem, self.device)),
                iterations=int(iterations), cg_iters=int(cg),
                device=self.device)
        return _InFlight(result)

    def solve(self, iterations: int, pick=ba.pick_cg_iters,
              eager: bool = False) -> ba.BAResult:
        return self.solve_async(iterations, pick, eager).get()

    def apply_poses(self, result: ba.BAResult, map_db: MapDB,
                    only: Optional[Set[KfId]] = None) -> None:
        # .get(): with deferred apply (pipelinedLocalBA) a keyframe in the
        # problem may have been removed (pose-trail drop / non-KF removal)
        # between dispatch and collect
        poses = np.asarray(result.poses[:len(self.kf_ids)], np.float64)
        poses = _orthonormalize_many(poses)
        for i, kf_id in enumerate(self.kf_ids):
            if only is not None and kf_id not in only:
                continue
            kf = map_db.keyframes.get(kf_id)
            if kf is not None:
                kf.pose_cw = poses[i]

    def apply_points(self, result: ba.BAResult, map_db: MapDB) -> None:
        points = np.asarray(result.points, np.float64)
        # object attributes one by one (each map point owns its array), but
        # the columnar mirror in ONE vectorized write instead of a
        # write-through store update per point
        store = map_db.mp_store
        rows = np.full(len(self.mp_ids), -1, np.int64)
        for i, mp_id in enumerate(self.mp_ids):
            mp = map_db.map_points.get(mp_id)
            if mp is not None:
                object.__setattr__(mp, "position", points[i].copy())
                rows[i] = mp._row
        live = rows >= 0
        store.position[rows[live]] = points[:len(rows)][live]

    def prune_outliers(self, result: ba.BAResult, map_db: MapDB) -> None:
        """chi2 > 5.991 observation pruning (reference:
        bundle_adjuster.cpp:376-388)."""
        chi2 = np.asarray(result.obs_chi2)
        for i in np.flatnonzero(chi2[:len(self.obs_tag)] > CHI2_THRESHOLD):
            kf_id, mp_id = self.obs_tag[i]
            mp = map_db.map_points.get(mp_id)
            kf = map_db.keyframes.get(kf_id)
            if mp is None or kf is None or kf_id not in mp.observations:
                continue
            mp.erase_observation(kf_id)
            kf.erase_observation(mp_id)
            if len(mp.observations) <= 2:
                mp.status = MapPointStatus.UNSURE


# ---------------------------------------------------------------------------


def collect_pending_ba(workspace: WorkspaceBA, map_db: MapDB
                       ) -> Optional[PendingLocalBA]:
    """Collect + apply a deferred local-BA solve (``pipelinedLocalBA``).

    Returns the pending record (so the caller can run the post-BA pipeline
    tail for that keyframe) or None if nothing was in flight."""
    pending = workspace.pending
    if pending is None:
        return None
    workspace.pending = None
    with section("ba_collect_deferred"):
        result = pending.device_result.get()
    with section("ba_apply"):
        b = pending.builder
        if pending.kind == Ba.NEIGHBOR:
            b.apply_poses(result, map_db, only={pending.kf_id})
            b.apply_points(result, map_db)
        else:
            b.prune_outliers(result, map_db)
            b.apply_poses(result, map_db)
            b.apply_points(result, map_db)
        # the prev-pose chain snapshot was taken pre-apply; re-sync it so the
        # next keyframe's seeded pose matches the synchronous pipeline
        map_db.refresh_prev_pose()
    return pending


@timed
def local_bundle_adjust(keyframe: Keyframe, workspace: WorkspaceBA,
                        map_db: MapDB, problem_max_size: int,
                        settings: StaticSettings,
                        defer: bool = False,
                        adjacent_kf_ids: Optional[List[KfId]] = None
                        ) -> bool:
    """reference: bundle_adjuster.cpp:141-394.

    With ``defer=True`` (pipelinedLocalBA) the solve is dispatched
    asynchronously and stashed in ``workspace.pending``; returns True in that
    case (the caller must skip the post-BA tail and finalize later via
    ``collect_pending_ba``). Returns False when applied synchronously."""
    assert workspace.pending is None, "previous deferred BA was never collected"
    parameters = settings.parameters.slam
    iterations = int(1 + math.sqrt(problem_max_size))

    local_keyframes = workspace.local_kf_ids
    local_keyframes.clear()
    local_map_points = workspace.local_mp_ids
    local_map_points.clear()

    adjacent = compute_adjacent_keyframes(keyframe, 15, problem_max_size,
                                          map_db, settings)
    local_keyframes.add(keyframe.id)
    local_keyframes.update(adjacent)
    # stabilizing island: force the 6 newest keyframes in
    # (reference: bundle_adjuster.cpp:187-193)
    for i, kf_id in enumerate(sorted(map_db.keyframes, reverse=True)):
        local_keyframes.add(kf_id)
        if i >= 5:
            break

    # vectorized map-point collection: unique positive slots over the local
    # keyframes, then one columnar status gather over the unique ids
    vals_per_kf = [map_db.keyframes[k].map_points for k in local_keyframes]
    pos_vals = np.concatenate(vals_per_kf)
    uniq = np.unique(pos_vals[pos_vals >= 0])
    store = map_db.mp_store
    rows, live = store.rows_of(uniq)
    keep = live & (store.status[rows] == int(MapPointStatus.TRIANGULATED))
    tri_rows = rows[keep]
    tri_mps = [store.objs[r] for r in tri_rows.tolist()]
    local_mp_vals = uniq[keep]
    local_map_points.update(local_mp_vals.tolist())
    cur_vals = keyframe.map_points[keyframe.map_points >= 0]
    n_current_frame_mps = int(np.isin(cur_vals, local_mp_vals).sum())

    if parameters.kfAsciiBA:
        # reference: bundle_adjuster.cpp:225-233
        from slam_tpu_torch.utils.ascii_viz import ascii_keyframes
        ascii_keyframes(lambda k: "." if k in local_keyframes else " ",
                        map_db, parameters.kfAsciiWidth)

    if (not local_keyframes
            or n_current_frame_mps < parameters.minVisibleMapPointsInCurrentFrameBA
            or len(local_keyframes) < parameters.minKeyframesInBA):
        return False

    builder = _ProblemBuilder(settings, workspace.device)
    for kf_id in sorted(local_keyframes):
        builder.add_keyframe(map_db.keyframes[kf_id], fixed=(kf_id != keyframe.id))
    # map points enter in ascending-id order (tri_mps is np.unique-sorted),
    # so slot == rank in local_mp_vals and the per-observation slot lookup
    # below is one searchsorted instead of a dict get per observation
    builder.add_map_points_bulk(tri_mps, fixed=False,
                                positions=store.position[tri_rows])
    # observations, bulk per keyframe (same (kf, mp) set as the reference's
    # per-map-point loop; order within the padded arrays is irrelevant)
    for kf_id in sorted(local_keyframes):
        kf = map_db.keyframes[kf_id]
        sel = np.flatnonzero(np.isin(kf.map_points, local_mp_vals))
        if len(sel) == 0:
            continue
        vals = kf.map_points[sel]
        mp_slots = np.searchsorted(local_mp_vals, vals).astype(np.int32)
        builder.add_observations_bulk(kf, sel, mp_slots, vals.tolist())
    # chain all local keyframes with odometry edges (descending id order,
    # reference: bundle_adjuster.cpp:296-311)
    other = KfId(-1)
    for kf_id in sorted(local_keyframes, reverse=True):
        if other.valid:
            builder.add_odometry_edge(other, kf_id, map_db)
        other = kf_id
    for edge in map_db.loop_closure_edges:
        builder.add_loop_edge(edge.kf_id1, edge.kf_id2, edge.pose_diff)

    if n_current_frame_mps < parameters.minVisibleMapPointsInNeighborhoodBA:
        # stage 1 only: refine the current keyframe, then stop ("NEIGHBOR" BA)
        workspace.ba_stats.update(Ba.NEIGHBOR)
        if defer:
            device_result = builder.solve_async(iterations)
            workspace.pending = PendingLocalBA(
                device_result, builder, keyframe.id,
                list(adjacent_kf_ids or []), Ba.NEIGHBOR)
            return True
        result = builder.solve(iterations)
        builder.apply_poses(result, map_db, only={keyframe.id})
        builder.apply_points(result, map_db)
        return False

    # both stages fused into one device call: stage 1 refines the current
    # keyframe with everything else fixed; stage 2 unfixes all poses and
    # softly anchors the current keyframe's stage-1 orientation
    # (bundle_adjuster.cpp:339-370).
    # DEVIATION (documented, docs/ARCHITECTURE.md §4): the reference zeroes
    # the anchor's translation information and relies on f64 g2o damping to
    # keep the un-gauged global-translation direction still. In the f32
    # device solver the gradient noise along that null direction is
    # amplified by 1/lambda and the whole local window drifts metres over a
    # sequence; a weak translation block (the per-edge odometry position
    # strength) regularizes the gauge with negligible (<1%) bias relative to
    # the odometry-chain constraints.
    r = 100.0 * parameters.odometryPriorStrengthRotation
    tr = parameters.odometryPriorStrengthPosition
    anchor_info = np.zeros((6, 6))
    anchor_info[:3, :3] = np.eye(3) * r * r
    anchor_info[3:, 3:] = np.eye(3) * tr * tr
    with section("ba_build"):
        problem = builder.build()
        K, M = problem.poses.shape[0], problem.points.shape[0]
        stage2_fixed = np.zeros(K, bool)
        ba.fill_padding(stage2_fixed[None], "stage2_pose_fixed",
                        len(builder.kf_ids))
        dev = workspace.device
        args = (ba.BAProblem(*_staged(problem, dev)),
                *_staged([stage2_fixed,
                          np.asarray(builder.kf_slot[keyframe.id]),
                          _sqrt_info(anchor_info).astype(np.float32)], dev))
    cg = ba.pick_cg_iters(K, M)
    workspace.ba_stats.update(Ba.LOCAL)
    # on a card: the inputs' copy into the bucket's buffers and the graph's
    # replay are enqueued here; the device's time shows in the collector's
    # wait (ba_collect_deferred) or in ba_solve_device
    if defer:
        with section("ba_dispatch_deferred"):
            device_result = _InFlight(ba.solve_ba_two_stage(
                *args, iterations=int(iterations), cg_iters=int(cg),
                device=dev))
        workspace.pending = PendingLocalBA(device_result, builder, keyframe.id,
                                           list(adjacent_kf_ids or []), Ba.LOCAL)
        return True
    with section("ba_solve_device"):
        result = _InFlight(ba.solve_ba_two_stage(
            *args, iterations=int(iterations), cg_iters=int(cg),
            device=dev)).get()

    with section("ba_apply"):
        builder.prune_outliers(result, map_db)
        builder.apply_poses(result, map_db)
        builder.apply_points(result, map_db)
    return False


@timed
def pose_bundle_adjust(keyframe: Keyframe, map_db: MapDB,
                       settings: StaticSettings, *, device) -> bool:
    """reference: bundle_adjuster.cpp:396-491. The solve runs on
    ``device``."""
    parameters = settings.parameters.slam
    store = map_db.mp_store
    sel = np.flatnonzero(keyframe.map_points >= 0)
    vals = keyframe.map_points[sel]
    rows, live = store.rows_of(vals)
    keep = live & (store.status[rows] == int(MapPointStatus.TRIANGULATED))
    sel, vals, rows = sel[keep], vals[keep], rows[keep]
    if len(sel) < parameters.minVisibleMapPointsInCurrentFrameBA:
        return False
    if not keyframe.previous_kf_id.valid:
        return False

    builder = _ProblemBuilder(settings, device)
    builder.add_keyframe(keyframe, fixed=False)
    builder.add_keyframe(map_db.keyframes[keyframe.previous_kf_id], fixed=True)
    builder.add_odometry_edge(keyframe.id, keyframe.previous_kf_id, map_db)
    mps = [store.objs[r] for r in rows.tolist()]
    builder.add_map_points_bulk(mps, fixed=True,
                                positions=store.position[rows])
    builder.add_observations_bulk(
        keyframe, sel, np.arange(len(sel), dtype=np.int32),
        [mp.id for mp in mps])

    result = builder.solve(parameters.poseBAIterations)
    builder.apply_poses(result, map_db, only={keyframe.id})
    return True


def never_triangulated(mp: MapPoint) -> bool:
    """A track's map point that was never triangulated: NOT_TRIANGULATED
    with no position (it waits at the origin). The global BA leaves it out
    and the loop correction does not move it."""
    return (mp.status == MapPointStatus.NOT_TRIANGULATED
            and not np.any(mp.position))


@timed
def global_bundle_adjust(current_kf_id: KfId, map_db: MapDB,
                         settings: StaticSettings, *, device) -> None:
    """reference: bundle_adjuster.cpp:493-604. The solve runs on
    ``device``. Unlike the JAX package, it leaves out a track's map point
    that was never triangulated: it waits at the origin, and its
    observations' huge residuals made the f32 solve accept steps that
    moved every keyframe. And it solves its camera system exactly where
    the dense system fits (``ops/ba.pick_global_cg_iters``), where the JAX
    package stops PCG at 96 steps. And it runs op by op
    (``ops/ba.solve_ba_eager``), where the JAX package's is one jitted
    program: it runs once a closure, at a size that rarely comes again (K
    48-624), and its dense solve peaks at about 586 B a padded pose-point
    pair (up to 9.9 GB at ``GLOBAL_DENSE_MAX_KM``), which a graph's private
    pool would hold for the rest of the process."""
    parameters = settings.parameters.slam
    builder = _ProblemBuilder(settings, device)
    for kf_id in sorted(map_db.keyframes):
        # note: global BA FIXES the current keyframe (bundle_adjuster.cpp:515)
        builder.add_keyframe(map_db.keyframes[kf_id], fixed=(kf_id == current_kf_id))
    for mp_id in sorted(map_db.map_points):
        mp = map_db.map_points[mp_id]
        if not mp.observations or never_triangulated(mp):
            continue
        builder.add_map_point(mp, fixed=False)
    for kf_id in sorted(map_db.keyframes):
        kf = map_db.keyframes[kf_id]
        sel = np.array([i for i in np.flatnonzero(kf.map_points >= 0)
                        if MpId(int(kf.map_points[i])) in builder.mp_slot],
                       np.int64)
        if len(sel) == 0:
            continue
        mp_ids = [MpId(int(v)) for v in kf.map_points[sel]]
        mp_slots = np.array([builder.mp_slot[m] for m in mp_ids])
        builder.add_observations_bulk(kf, sel, mp_slots, mp_ids)
    for kf_id in sorted(map_db.keyframes):
        kf = map_db.keyframes[kf_id]
        if kf.previous_kf_id.valid:
            builder.add_odometry_edge(kf.id, kf.previous_kf_id, map_db)
    for edge in map_db.loop_closure_edges:
        ok = builder.add_loop_edge(edge.kf_id1, edge.kf_id2, edge.pose_diff)
        assert ok
    result = builder.solve(parameters.globalBAIterations,
                           ba.pick_global_cg_iters, True)    # eager
    builder.prune_outliers(result, map_db)
    builder.apply_poses(result, map_db)
    builder.apply_points(result, map_db)


def _orthonormalize(T: np.ndarray) -> np.ndarray:
    """Project the rotation back to SO(3) after float32 accumulation."""
    return _orthonormalize_many(T[None])[0]


def _orthonormalize_many(T: np.ndarray) -> np.ndarray:
    """Batched ``_orthonormalize`` over (K, 4, 4) poses: one stacked SVD
    replaces the per-pose LAPACK calls on the apply path."""
    T = np.asarray(T, np.float64).reshape(-1, 4, 4)
    U, _, Vt = np.linalg.svd(T[:, :3, :3])
    R = U @ Vt
    flip = np.linalg.det(R) < 0
    if flip.any():
        Uf = U[flip].copy()
        Uf[:, :, 2] *= -1.0
        R[flip] = Uf @ Vt[flip]
    out = np.tile(np.eye(4), (len(T), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = T[:, :3, 3]
    return out
