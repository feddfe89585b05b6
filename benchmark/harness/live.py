"""Live traffic: one ``Slam`` session, closed loop, one frame at a time.

The sequence is rendered on the card from the seed during set-up. Set-up
runs a throwaway tracker and session over the first frames (every op of
the path once, the kernels built) and prewarms the padded BA buckets the
cell lists (each bucket's first call eager, its second captured). The
window then drives a fresh ``DescriptorTracker`` and ``Slam`` from frame
0: each frame goes through ``DescriptorTracker.process`` and then
``Slam.add_frame``; the next frame is tracked and prefetched
(``Mapper.prefetch``) before the current one is submitted, and the loop
waits on each future. A frame's latency runs from the moment it is handed
to the tracker to its pose ``Result``.

The window keeps, drawn from the seed, some of the Mapper's local BAs: each
solve's problem, and the keyframe poses and map points the map kept right
after the Mapper applied it, for the reference to solve again once the
window has closed.
"""
from __future__ import annotations

import inspect
import os
import sys
import threading
import time

import numpy as np
import torch

from harness import reference, scenes
from harness.sampling import Reservoir

BA_ENTRIES = ("solve_ba", "solve_ba_two_stage")
# the benchmark's own host spans around calls into the program
SPANS = ("live.tracker", "live.prefetch", "live.add_frame",
         "live.extract.tracker", "live.extract.mapper")


class Live:
    def __init__(self, cfg, mix, cell, seed, device, spans):
        from slam_tpu_torch.geometry.camera import PinholeCamera
        from slam_tpu_torch.params import Parameters, ParametersSlam

        self.device = torch.device(device)
        self.spans = spans
        self.cell = cell
        self.n = int(cell["frames"])
        self.cam = scenes.Camera(cfg["camera"])
        self.camera = PinholeCamera(**cfg["camera"])
        self.fps = float(cfg["trajectory"]["fps"])
        self.times, self.truth = scenes.trajectory(cfg["trajectory"], self.n)
        scene = scenes.make_scene(cfg["scene"], seed, self.device)
        self.frames = scenes.render_frames(scene, self.truth, self.cam,
                                           self.device)
        rng = np.random.default_rng([seed, 1])
        self.odo = scenes.drifted_odometry(
            self.truth, float(cell["drift"]), float(cell.get("drift_yaw", 0)),
            rng)
        self.params = Parameters(slam=ParametersSlam(**cfg["slam"]))
        smp = cell["sample"]
        self.words = Reservoir(int(smp["extractions"]),
                               np.random.default_rng([seed, 5]))
        self.applied = Reservoir(int(smp["applied"]),
                                 np.random.default_rng([seed, 8]))
        # the solve and the problem builder of the local BA running on
        # this thread
        self._tls = threading.local()
        self.done = 0
        self.slam = None
        # set by benchmark/control.py only: the reference in this dtype
        # stands in the program's place for the BA comparison
        self.control_dtype = None
        self.trace_span = tuple(mix["trace_span"])

    # ------------------------------------------------------------ session

    def _tracker(self):
        from slam_tpu_torch.frontends.descriptor_tracker import \
            DescriptorTracker
        from slam_tpu_torch.params import StaticSettings

        return DescriptorTracker(StaticSettings(self.params), self.cam.width,
                                 self.cam.height, device=self.device)

    def _input(self, i, tf, trail):
        from slam_tpu_torch.map.keyframe import MapperInput, Pose

        trail.insert(0, Pose(frame_number=i, t=float(self.times[i]),
                             pose_cw=self.odo[i].copy()))
        del trail[8:]
        return MapperInput(frame=self.frames[i], camera=self.camera,
                           track_ids=tf.tracked_id_list,
                           track_pts=tf.tracked_pts, track_depths=None,
                           pose_trail=list(trail), t=float(self.times[i]))

    def _drive(self, tracker, slam, seconds, limit, trace=None,
               trace_frames=(0, 0)):
        """The closed loop; returns (latencies, window seconds)."""
        sp = self.spans
        trail = []
        lat = []
        t0 = time.perf_counter()
        handed = time.perf_counter()
        with sp.span("live.tracker"):
            mi = self._input(0, tracker.process(self.frames[0]), trail)
        i = 0
        while True:
            if trace is not None and i == trace_frames[0]:
                trace.start()
            nxt = None
            if i + 1 < self.n:
                handed_next = time.perf_counter()
                with sp.span("live.tracker"):
                    tf = tracker.process(self.frames[i + 1])
                nxt = self._input(i + 1, tf, trail)
                with sp.span("live.prefetch"):
                    slam.mapper.prefetch(nxt)
            with sp.span("live.add_frame"):
                res = slam.add_frame(frame=mi.frame, pose_trail=mi.pose_trail,
                                     features_ids=mi.track_ids,
                                     features_pts=mi.track_pts,
                                     camera=self.camera).result()
            now = time.perf_counter()
            assert res.pose_mat.shape == (4, 4)
            lat.append(now - handed)
            i += 1
            if trace is not None and i == trace_frames[1]:
                trace.stop()
            if now - t0 >= seconds or i >= limit:
                if trace is not None and trace.t1 is None and \
                        trace.t0 is not None:
                    trace.stop()
                break
            if nxt is None:
                raise RuntimeError(
                    f"the window outran the cell's {self.n} frames")
            mi, handed = nxt, handed_next
        return lat, now - t0

    def warm(self):
        """A throwaway session over the first frames, then the BA buckets."""
        from slam_tpu_torch.pipeline.slam_api import Slam

        slam = Slam.build(self.params, device=self.device)
        self._drive(self._tracker(), slam, float("inf"),
                    int(self.cell["warmup_frames"]))
        slam.end().result()
        for b in self.cell.get("ba_buckets", []):
            prewarm_bucket(b, self.device)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, trace=None):
        trace_frames = self.trace_span
        from slam_tpu_torch.ops import ba
        from slam_tpu_torch.ops import frontend
        from slam_tpu_torch.pipeline.slam_api import Slam

        tracker = self._tracker()
        slam = Slam.build(self.params, device=self.device)
        self._record_words(frontend.OrbExtractor, tracker.extractor)
        self._record_ba(ba)
        self._record_applied()
        buckets = ba.BA_GRAPHS.counters()["buckets"]
        self._sync()
        lat, window_s = self._drive(tracker, slam, seconds, self.n, trace,
                                    trace_frames)
        self._sync()
        # a bucket the cell's list misses runs eagerly, then is captured,
        # inside the window
        print(f"BA buckets first met in the window: "
              f"{ba.BA_GRAPHS.counters()['buckets'] - buckets}",
              file=sys.stderr)
        self.done = len(lat)
        self.slam = slam
        # frames whose latency the profiler's stretch touches: tracked or
        # submitted while it ran
        untraced = (lat if trace is None else
                    lat[:trace_frames[0]] + lat[trace_frames[1] + 1:])
        return dict(kind="live", window_s=window_s, frames=len(lat),
                    latencies_s=lat, untraced_latencies_s=untraced,
                    traced_frames=trace_frames[1] - trace_frames[0])

    # ------------------------------------------------------------ records

    def _record_words(self, cls, tracker_ex):
        det = cls.detect_and_extract
        words = self.words
        spans = self.spans

        def recorded(ex, *a, **k):
            who = "tracker" if ex is tracker_ex else "mapper"
            with spans.span(f"live.extract.{who}"):
                res = det(ex, *a, **k)
            words.offer(lambda: (res.descriptors.copy(), res.words.copy(),
                                 res.valid.copy()))
            return res

        cls.detect_and_extract = recorded

    def _record_ba(self, ba):
        """Each BA solve's arguments, kept for this thread until the local
        BA around it has applied it (``_record_applied``)."""
        tls = self._tls
        for entry in BA_ENTRIES:
            fn = getattr(ba, entry)
            sig = inspect.signature(fn)

            def recorded(*a, _fn=fn, _sig=sig, _entry=entry, **k):
                bound = _sig.bind(*a, **k)
                bound.apply_defaults()
                tls.solve = (_entry, dict(bound.arguments))
                return _fn(*a, **k)

            setattr(ba, entry, recorded)

    def _record_applied(self):
        """Around the Mapper's local BA: once it has applied its solve,
        the poses of the keyframes it wrote (all of the problem's for the
        two-stage solve, the current one's for the neighbour solve) and
        the positions of its map points, as the map keeps them, beside the
        solve's problem."""
        from slam_tpu_torch.pipeline import bundle_adjustment as bundle
        from slam_tpu_torch.pipeline import mapper_helpers

        tls, applied = self._tls, self.applied
        build = bundle._ProblemBuilder.build
        local = mapper_helpers.local_bundle_adjust

        def built(builder):
            tls.builder = builder
            return build(builder)

        def recorded(keyframe, workspace, map_db, *a, **k):
            tls.builder = tls.solve = None
            deferred = local(keyframe, workspace, map_db, *a, **k)
            b, solve = tls.builder, tls.solve
            if deferred or b is None or solve is None:
                return deferred
            entry, args = solve
            ids = (b.kf_ids if entry == "solve_ba_two_stage"
                   else [keyframe.id])

            def make():
                kfs = [(b.kf_slot[i], map_db.keyframes.get(i)) for i in ids]
                mps = [(j, map_db.map_points.get(m))
                       for j, m in enumerate(b.mp_ids)]
                kfs = [(j, kf) for j, kf in kfs if kf is not None]
                mps = [(j, mp) for j, mp in mps if mp is not None]
                return dict(
                    entry=entry,
                    problem=[t.clone() for t in args["p"]],
                    extra=[args[n].clone() for n in
                           ("stage2_pose_fixed", "anchor_slot",
                            "anchor_sqrt_info") if n in args],
                    static={n: args[n] for n in
                            ("iterations", "cg_iters", "huber_delta",
                             "init_lambda")},
                    kf_slots=[j for j, _ in kfs],
                    kf_poses=np.array([kf.pose_cw for _, kf in kfs],
                                      np.float64).reshape(-1, 4, 4),
                    mp_slots=[j for j, _ in mps],
                    mp_points=np.array([mp.position for _, mp in mps],
                                       np.float64).reshape(-1, 3))

            applied.offer(make)
            return deferred

        bundle._ProblemBuilder.build = built
        mapper_helpers.local_bundle_adjust = recorded

    # ------------------------------------------------------------ checks

    def judge(self, seed) -> tuple:
        """(numbers, attempted, failed) of the finished window: ``end``
        drains the session, the map is read, the program's state is
        freed, then the reference judges the samples."""
        assert self.slam.end().result()
        nums = self.map_numbers(self.slam.mapper)
        self.slam = None
        # a raw file both sides read: the program's trained vocabulary
        vocab = np.load(os.path.join(os.getcwd(),
                                     self.cell["vocabulary"]))["codebook"]
        nums.update(self.numbers(vocab))
        return nums, self.done, 0

    def numbers(self, vocabulary: np.ndarray) -> dict:
        dev = self.device
        # K1's words against the plain argmin over the vocabulary
        mism = 0
        for desc, words, valid in self.words.items():
            _, idx = reference.hamming_argmin(desc[valid], vocabulary, dev)
            mism += int((idx != words[valid]).sum())
        # what the map kept after sampled local BAs against the reference's
        # solve of the same problems
        pose_gap = point_gap = 0.0
        for r in self.applied.items():
            p, x = applied_gaps(r, dev, self.control_dtype)
            pose_gap, point_gap = max(pose_gap, p), max(point_gap, x)
        if not self.applied.items():
            pose_gap = point_gap = float("inf")
        return dict(word_mismatches=mism, map_pose_gap_m=pose_gap,
                    map_point_gap_m=point_gap)

    def map_numbers(self, mapper) -> dict:
        """Loop-closure edges whose keyframes lie far apart in the truth."""
        db = mapper.map_db
        truth_c = reference.camera_centers(self.truth)
        false_closures = 0
        max_m = float(self.cell["closure_max_m"])
        for e in db.loop_closure_edges:
            a, b = db.keyframes.get(e.kf_id1), db.keyframes.get(e.kf_id2)
            if a is None or b is None:
                continue
            fa, fb = int(round(a.t * self.fps)), int(round(b.t * self.fps))
            if np.linalg.norm(truth_c[fa] - truth_c[fb]) > max_m:
                false_closures += 1
        return dict(false_closures=false_closures)

def _ref_solve(r: dict, s: int, dtype, device):
    """The reference's solve of a recorded problem: (poses, points) as
    float64 arrays."""
    st = r["static"]
    p = reference.problem(r["problem"], s, dtype, device)
    if r["entry"] == "solve_ba_two_stage":
        fixed2, slot, info = r["extra"]
        poses, points, _ = reference.two_stage_lm(
            p, fixed2[s].to(device), int(slot[s]), info[s].to(device),
            st["iterations"], st["cg_iters"], st["huber_delta"],
            st["init_lambda"])
    else:
        poses, points, _ = reference.lm_run(
            p, st["iterations"], st["cg_iters"], st["huber_delta"],
            st["init_lambda"])
    return poses.double().cpu().numpy(), points.double().cpu().numpy()


def applied_gaps(r: dict, device, control_dtype=None) -> tuple:
    """(largest camera-centre gap, largest point gap) between what the map
    kept after a local BA and the reference's float64 solve of its
    problem; with ``control_dtype``, the reference's own solve in that
    dtype stands in for the map (the control)."""
    ref_p, ref_x = _ref_solve(r, 0, torch.float64, device)
    kf, mp = r["kf_slots"], r["mp_slots"]
    if control_dtype is None:
        got_p, got_x = r["kf_poses"], r["mp_points"]
    else:
        ctl_p, ctl_x = _ref_solve(r, 0, control_dtype, device)
        got_p, got_x = ctl_p[kf], ctl_x[mp]
    pose = (np.linalg.norm(reference.camera_centers(got_p)
                           - reference.camera_centers(ref_p[kf]), axis=-1)
            if kf else np.zeros(1))
    point = (np.linalg.norm(got_x - ref_x[mp], axis=-1) if mp
             else np.zeros(1))
    return float(pose.max()), float(point.max())


def prewarm_bucket(b: dict, device) -> None:
    """Run a padded BA bucket twice (eager, then captured) on a problem of
    its shapes; ``b`` lists each input's shape and dtype and the static
    arguments, as ``BA_GRAPHS`` keys its buckets."""
    from slam_tpu_torch.ops import ba

    tensors = []
    for shape, dtype in b["inputs"]:
        dt = getattr(torch, dtype)
        if dt == torch.bool:
            t = torch.zeros(shape, dtype=dt)
        elif dt.is_floating_point:
            t = torch.zeros(shape, dtype=dt)
            if len(shape) >= 2 and shape[-1] == shape[-2]:
                t += torch.eye(shape[-1], dtype=dt)
        else:
            t = torch.zeros(shape, dtype=dt)
        tensors.append(t)
    tensors[2] += torch.tensor([0.0, 0.0, 1.0])           # points ahead
    n = len(ba.BAProblem._fields)
    for _ in range(2):
        p = ba.BAProblem(*tensors[:n])
        getattr(ba, b["entry"])(p, *tensors[n:], device=device, **b["static"])


make = Live
