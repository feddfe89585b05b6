#!/usr/bin/env python
"""Trace the loop closure and bundle adjustments of a rendered session.

``--scene room`` runs ``run(n_frames, drift)`` of
``tools/torch_run_euroc_synthetic.py`` (the EuRoC-class room, 20 Hz);
``--scene street`` runs ``drive`` of ``tools/torch_run_kitti_synthetic.py``
(the KITTI-class street, 10 Hz, blackout at mid-run). ``--package torch``
runs the port on ``--device``; ``--package jax`` runs the JAX package's
original tool on the CPU. Against the rendered ground truth it prints:

  * every 20 frames: the keyframes' ATE (translation-aligned), the newest
    keyframe's camera-centre error and the odometry's;
  * each track reset (a frame that shares no track id with the one before
    it): the keyframes' ATE before and after that frame, and again after
    the first frame whose tracks resume;
  * each loop-closure candidate that reaches Sim3 RANSAC: its frame, the
    pair, the matches and the outcome;
  * each loop correction: its frame, the pair, the keyframes' ATE before
    and after it;
  * each global BA: K and M (padded), the observed map points never
    triangulated (at the origin, status NOT_TRIANGULATED: the JAX package's
    global BA takes them, the port's leaves them out) and their
    observations, how many of those the loop correction moved off the
    origin, the solver branch (dense Schur or the PCG budget), the cost before and
    after, the LM steps accepted, and the keyframes' ATE before and after;
  * each local BA that moves a camera more than 5 cm or the ATE by more
    than 5 mm (room only; every street frame is a keyframe);
  * at the end of a street drive, in the result: the Sim3-fit scale of the
    keyframes 0-99 and of all of them (``street_proxy.sim3_scale``), and the
    odometry's mean sideways error a step over the same keyframes.

``--replay-kf K`` (torch, room or street) stops at keyframe K's local BA
instead and solves that problem again (``ops/ba.two_stage_lm``) on the card
and on the CPU in f32 and in f64, printing how far each moves the cameras
and its final cost; then splits it and solves it again from the truth
(``Tracer.truth_replay``: the newest keyframe's error, its step along the
track and the window's Sim3-fit scale before the BA and after each stage;
the new points' and window points' depths against the truth; the
reprojection residuals at the truth by pyramid level; and from the truth,
both stages, then stage 2 with every term, without the odometry edges,
without the anchor, with the odometry edges at the truth, at the truth but
their measured sideways part, and at the truth +- 5 mm sideways a step);
``--save`` keeps the problem. ``--replay-global`` (torch) captures the
first global BA's problem, stops the session there, and solves it again on
the card and on the CPU with each budget of ``--budgets`` (0 = dense Schur,
solved only where the port's global BA would solve it so) and each LM step
count of ``--iterations``, printing the keyframes' ATE, the cost, the
accepted LM steps and, on the card, the solve's peak allocation each gives;
``--save`` keeps the problem, ``--load`` solves a kept one again without
the session.

Usage:
  python tools/trace_euroc_ba.py [--scene room|street] [--package torch|jax]
      [--frames N] [--drift SIGMA] [--drift-yaw RAD] [--radius M]
      [--seed S] [--no-reloc] [--device cuda|cpu] [--replay-kf K]
      [--replay-global] [--budgets 96,384,0] [--iterations 10,40]
      [--devices cuda,cpu] [--save PROBLEM.npz] [--load PROBLEM.npz]
"""
import argparse
import importlib
import json
import os
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from slam_tpu_torch.pipeline.bundle_adjustment import \
    never_triangulated  # noqa: E402  (the port's rule, for both packages)
from street_proxy import sim3_scale  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "torch_tools")


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def aligned_ate(centres, truth):
    """RMSE of the camera centres against the truth after removing the mean
    offset (translation alignment)."""
    e = np.asarray(centres) - np.asarray(truth)
    e -= e.mean(0)
    return float(np.sqrt((e ** 2).sum(1).mean()))


def triangulate_at(poses, points, obs_kf, obs_mp, obs_meas, obs_si,
                   obs_valid, steps=5):
    """Every point of a BA problem triangulated from its valid observations
    through ``poses`` (K, 4, 4): the linear least-squares solve, then
    ``steps`` Gauss-Newton steps on the whitened reprojection error.
    Returns (points (M, 3), ok (M,)): ok where two or more observations
    see the point in front of their cameras."""
    M = len(points)
    o = np.flatnonzero(obs_valid)
    T = poses[obs_kf[o]]
    R, t = T[:, :3, :3], T[:, :3, 3]
    xy, w = obs_meas[o], obs_si[o][:, None, None]
    A = (xy[:, :, None] * R[:, 2:3, :] - R[:, :2, :]) * w     # (n, 2, 3)
    rhs = (t[:, :2] - xy * t[:, 2:3]) * w[..., 0]              # (n, 2)
    N = np.zeros((M, 3, 3))
    v = np.zeros((M, 3))
    np.add.at(N, obs_mp[o], np.einsum("nci,ncj->nij", A, A))
    np.add.at(v, obs_mp[o], np.einsum("nci,nc->ni", A, rhs))
    count = np.bincount(obs_mp[o], minlength=M)
    ok = count >= 2
    N[~ok] = np.eye(3)
    X = np.where(ok[:, None], np.linalg.solve(N, v[..., None])[..., 0],
                 points)
    for _ in range(steps):
        pc = np.einsum("nij,nj->ni", R, X[obs_mp[o]]) + t
        z = pc[:, 2:3]
        r = (pc[:, :2] / z - xy) * w[..., 0]
        Jp = np.concatenate([np.eye(2)[None].repeat(len(o), 0),
                             -pc[:, :2, None] / z[..., None]], axis=2)
        J = (Jp / z[..., None]) @ R * w                        # (n, 2, 3)
        H = np.zeros((M, 3, 3))
        g = np.zeros((M, 3))
        np.add.at(H, obs_mp[o], np.einsum("nci,ncj->nij", J, J))
        np.add.at(g, obs_mp[o], np.einsum("nci,nc->ni", J, r))
        H[~ok] = np.eye(3)
        X = X - np.where(ok[:, None], np.linalg.solve(H, g[..., None])[..., 0],
                         0.0)
    z = np.einsum("nj,nj->n", R[:, 2], X[obs_mp[o]]) + t[:, 2]
    in_front = np.ones(M, bool)
    np.logical_and.at(in_front, obs_mp[o], z > 0)
    return X, ok & in_front


class GlobalTrace:
    """What one global BA's problem and solve looked like."""

    def __init__(self, problem, iterations, builder=None, cg=None):
        self.K, self.M = problem.poses.shape[-3], problem.points.shape[-2]
        self.nk = len(builder.kf_ids) if builder is not None else self.K
        self.nm = len(builder.mp_ids) if builder is not None else self.M
        self.iterations = iterations
        self.cg = cg                  # the PCG budget the solve ran, 0 dense
        self.costs = []               # cost0, one per LM step, final

    @property
    def branch(self):
        return "dense Schur" if self.cg == 0 else f"PCG {self.cg}"

    def steps(self):
        """(cost before, cost after, LM steps accepted) from the recorded
        costs: the initial one, then each step's trial cost."""
        c0 = best = self.costs[0]
        accepted = 0
        for c in self.costs[1:1 + self.iterations]:
            if c < best:
                best, accepted = c, accepted + 1
        return c0, best, accepted


def record_costs(ba_mod, fn):
    """Run ``fn()`` with the port's ``ops/ba._total_cost`` recording every
    cost it returns; returns (fn's value, the costs)."""
    costs, total = [], ba_mod._total_cost

    def recorded(*a, **k):
        out = total(*a, **k)
        costs.append(float(out[0].reshape(-1)[0]))
        return out

    ba_mod._total_cost = recorded
    try:
        return fn(), costs
    finally:
        ba_mod._total_cost = total


def record_cg(ba_mod, name, g, fn):
    """Run ``fn()`` with ``ba_mod.<name>`` (the solve that the BA builder
    calls) recording the ``cg_iters`` it is given in ``g.cg``."""
    solve = getattr(ba_mod, name)

    def recorded(*a, **k):
        g.cg = int(k["cg_iters"])
        return solve(*a, **k)

    setattr(ba_mod, name, recorded)
    try:
        return fn()
    finally:
        setattr(ba_mod, name, solve)


def jax_costs(jba, problem, iterations, cg):
    """The JAX LM's costs on ``problem``: a fresh trace of its ``_lm_run``
    whose ``_total_cost`` calls back with each cost (the package's own jit
    cache holds the traces without the callback)."""
    import jax

    costs, total = [], jba._total_cost

    def recorded(poses, points, p, huber_delta):
        out = total(poses, points, p, huber_delta)
        jax.debug.callback(lambda c: costs.append(float(c)), out[0],
                           ordered=True)
        return out

    jba._total_cost = recorded
    try:
        run = jax.jit(jba._lm_run, static_argnums=(1, 2))
        res = run(problem, iterations, cg, float(np.sqrt(jba.CHI2_THRESHOLD)),
                  1e-4)
        jax.block_until_ready(res)
        jax.effects_barrier()
    finally:
        jba._total_cost = total
    return costs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("room", "street"), default="room")
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--frames", type=int, default=None,
                    help="default 240 (room), 620 (street)")
    ap.add_argument("--drift", type=float, default=None,
                    help="default 0.004 (room), 0.01 (street)")
    ap.add_argument("--drift-yaw", type=float, default=4e-5,
                    help="street: heading-rate bias, rad/frame")
    ap.add_argument("--radius", type=float, default=None,
                    help="street: circuit radius, default the tool's 80 m")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-reloc", action="store_true",
                    help="street: skip the relocation pass")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replay-kf", type=int, default=None)
    ap.add_argument("--replay-global", action="store_true")
    ap.add_argument("--budgets", default=None,
                    help="--replay-global's PCG budgets, comma-separated; "
                         "0 = dense Schur (default: the reference's "
                         "budget, four times it, and the port's global BA's)")
    ap.add_argument("--iterations", default=None,
                    help="--replay-global's LM steps, comma-separated "
                         "(default: the session's)")
    ap.add_argument("--devices", default=None,
                    help="--replay-global's devices (default: cuda,cpu)")
    ap.add_argument("--save", default="",
                    help="--replay-global: write the captured problem and "
                         "the keyframes' true centres to this .npz; "
                         "--replay-kf: the captured problem, its stage-2 "
                         "arguments and the window keyframes' true poses")
    ap.add_argument("--load", default="",
                    help="--replay-global: solve the problem of a --save "
                         ".npz again instead of driving the session")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads (0: torch's default)")
    ap.add_argument("--every", type=int, default=20,
                    help="frames between two ATE lines")
    args = ap.parse_args(argv)
    street = args.scene == "street"
    if args.frames is None:
        args.frames = 620 if street else 240
    if args.drift is None:
        args.drift = 0.01 if street else 0.004
    if args.package == "jax":
        assert args.replay_kf is None and not args.replay_global, \
            "the replays solve the port's BA"
    return args


def main():
    args = parse_args()
    street = args.scene == "street"
    if args.threads:
        import torch
        torch.set_num_threads(args.threads)
    tracer = Tracer(args)
    if args.replay_kf is not None:
        return tracer.replay_local()
    if args.replay_global:
        return tracer.replay_global()
    res = tracer.run()
    if street:
        res.update(tracer.scale_fit())
    print(json.dumps(res))


class Tracer:
    """The hooks, installed on one package's mapper, loop closer and BA
    until ``close``."""

    def __init__(self, args):
        self.args = args
        self.undo = []        # (owner, name, value) of every patch
        jax_side = args.package == "jax"
        pkg = "slam_tpu" if jax_side else "slam_tpu_torch"
        if jax_side:
            import jax
            jax.config.update("jax_platforms", "cpu")
        if args.scene == "street":
            self.tool = importlib.import_module(
                "run_kitti_synthetic" if jax_side
                else "torch_run_kitti_synthetic")
            radius = args.radius or self.tool.RADIUS
            _, poses = self.tool.make_sequence(args.frames, radius=radius)
            self.fps = self.tool.FPS
        else:
            self.tool = importlib.import_module(
                "run_euroc_synthetic" if jax_side
                else "torch_run_euroc_synthetic")
            _, poses = self.tool.make_sequence(args.frames, 0)
            self.fps = 20.0
        self.gt_poses = np.asarray(poses, np.float64)
        self.gt = [_centre(p) for p in poses]
        self.helpers = importlib.import_module(pkg + ".pipeline.mapper_helpers")
        self.mapper_mod = importlib.import_module(pkg + ".pipeline.mapper")
        self.closer = importlib.import_module(pkg + ".pipeline.loop_closer")
        self.bamod = importlib.import_module(
            pkg + ".pipeline.bundle_adjustment")
        self.ba = importlib.import_module(pkg + ".ops.ba")
        self.status = importlib.import_module(
            pkg + ".map.map_point").MapPointStatus
        self.stats_mod = importlib.import_module(pkg + ".utils.stats")
        self.se3 = importlib.import_module(pkg + ".geometry.se3")
        self.pair = self.sim3 = None  # the candidate after RANSAC, its Sim3
        if jax_side:
            # the reference's audit raises a known false alarm (ROADMAP
            # section 3); audit its map with the port's
            self.patch(self.mapper_mod, "check_consistency",
                       importlib.import_module("slam_tpu_torch.pipeline."
                                               "mapper_helpers"
                                               ).check_consistency)
        self.frame = -1
        self.mapper = None    # the drive's (not the relocation pass's)
        self.prev_ids, self.after_reset = set(), False
        self.never = set()    # points never triangulated when a loop closed
        self.in_global = False
        self.globals = []     # GlobalTrace of each global BA
        self.on_global = None
        self.install()

    # ------------------------------------------------------------------

    def frame_of(self, t):
        return int(round(t * self.fps))

    def kf_ate(self, db):
        kfs = list(db.keyframes.values())
        return aligned_ate([_centre(kf.pose_cw) for kf in kfs],
                           [self.gt[self.frame_of(kf.t)] for kf in kfs])

    def scale_fit(self):
        """The Sim3-fit scale (``street_proxy.sim3_scale``) of the drive's
        keyframes 0-99 and of all of them against the truth, and the mean
        sideways (camera x) error of the odometry between consecutive
        keyframes, in mm a step, over the same spans: the part of the
        odometry edges' measurement that shortens the local BA's window
        (``--replay-kf``)."""
        kfs = sorted(self.mapper.map_db.keyframes.values(),
                     key=lambda kf: kf.t)
        frames = np.array([self.frame_of(kf.t) for kf in kfs])
        c = np.array([_centre(kf.pose_cw) for kf in kfs])
        truth = np.asarray(self.gt)[frames]
        first = frames <= 99
        side = np.array([
            (a.orig_pose_cw @ np.linalg.inv(b.orig_pose_cw)
             - self.gt_poses[i] @ np.linalg.inv(self.gt_poses[j]))[0, 3]
            for a, b, i, j in zip(kfs, kfs[1:], frames, frames[1:])])
        return {"sim3_scale_0_99": sim3_scale(c[first], truth[first]),
                "sim3_scale_all": sim3_scale(c, truth),
                "odometry_sideways_mm_0_99": 1e3 * float(
                    side[first[1:]].mean()),
                "odometry_sideways_mm_all": 1e3 * float(side.mean())}

    def patch(self, owner, name, value):
        self.undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def close(self):
        """Take the hooks out again."""
        while self.undo:
            setattr(*self.undo.pop())

    def install(self):
        def wrap(owner, name, fn):
            orig = getattr(owner, name)
            self.patch(owner, name, lambda *a, **k: fn(orig, *a, **k))

        wrap(self.mapper_mod.Mapper, "advance", self.advance)
        wrap(self.closer.LoopCloser, "correct_loop", self.correct)
        wrap(self.closer.LoopCloser, "_build_ransac", self.build_ransac)
        wrap(self.closer.LoopCloser, "_refine_transform", self.refine)
        wrap(self.stats_mod.LoopCloserStats, "update", self.outcome)
        wrap(self.helpers, "global_bundle_adjust", self.global_ba)
        wrap(self.bamod._ProblemBuilder, "solve", self.solve)
        if self.args.scene == "room":
            wrap(self.helpers, "local_bundle_adjust", self.local_ba)

    def advance(self, orig, mapper, mi):
        if self.mapper is None:
            self.mapper = mapper
        elif mapper is not self.mapper:
            return orig(mapper, mi)     # the relocation pass's session
        i = self.frame = self.frame_of(mi.t)
        db = mapper.map_db
        ids = set(int(v) for v in np.asarray(mi.track_ids).reshape(-1))
        prev = self.prev_ids
        reset = bool(prev) and not (ids & prev)
        resumed = self.after_reset and bool(ids)
        self.prev_ids = ids
        before = self.kf_ate(db) if reset and db.keyframes else None
        out = orig(mapper, mi)
        if reset:
            self.after_reset = True
            print(f"track reset at frame {i}: keyframes' ATE "
                  f"{before if before is not None else float('nan'):.4f} "
                  f"-> {self.kf_ate(db):.4f} m ({len(db.keyframes)} "
                  f"keyframes)", flush=True)
        elif resumed:
            self.after_reset = False
            print(f"tracks resume at frame {i} ({len(ids)} tracks): "
                  f"keyframes' ATE {self.kf_ate(db):.4f} m", flush=True)
        if (i + 1) % self.args.every == 0 and db.keyframes:
            kf = db.latest_keyframe()
            err = np.linalg.norm(_centre(kf.pose_cw)
                                 - self.gt[self.frame_of(kf.t)])
            odo = np.linalg.norm(_centre(mi.pose_trail[0].pose_cw)
                                 - self.gt[i])
            print(f"frame {i}: keyframes' ATE {self.kf_ate(db):.4f} m, "
                  f"newest keyframe {int(kf.id)} off by {err:.4f} m, "
                  f"odometry by {odo:.4f} m", flush=True)
        return out

    def build_ransac(self, orig, closer, kf1, kf2, matches, *a, **k):
        ransac = orig(closer, kf1, kf2, matches, *a, **k)
        solve = ransac.solve

        def traced(*sa, **sk):
            res = solve(*sa, **sk)
            print(f"  RANSAC at frame {self.frame}: keyframe {int(kf1.id)} "
                  f"<- {int(kf2.id)}, {len(matches)} matches, "
                  f"{int(np.sum(res.inliers)) if res.ok else 0} inliers, "
                  f"{'passed' if res.ok else 'failed'}", flush=True)
            return res

        ransac.solve = traced
        self.pair, self.sim3 = (kf1, kf2), None
        return ransac

    def refine(self, orig, closer, *a, **k):
        self.sim3 = orig(closer, *a, **k)
        return self.sim3

    def outcome(self, orig, stats, outcome):
        """Each candidate refined after RANSAC: the gates' verdict, with the
        correction distance and the time and path between the pair."""
        orig(stats, outcome)
        if self.pair is None or self.sim3 is None:
            return
        (cur, cand), sim3, se3 = self.pair, self.sim3, self.se3
        self.pair = self.sim3 = None
        # the loop closer's correction distance (loop_closer.cpp:280-290)
        updated = (sim3 * se3.Sim3.from_se3(cand.pose_cw)).to_se3()
        dist = np.linalg.norm(se3.camera_center(cur.pose_cw)
                              - se3.camera_center(updated))
        print(f"    -> {outcome.value}: correction {dist:.3f} m over "
              f"{cur.t - cand.t:.1f} s", flush=True)

    def correct(self, orig, closer, current_kf, loop_closure):
        db = closer.map_db
        a = self.kf_ate(db)
        self.never.update(i for i, mp in db.map_points.items()
                          if never_triangulated(mp))
        orig(closer, current_kf, loop_closure)
        print(f"loop correction at frame {self.frame}, keyframe "
              f"{int(current_kf.id)} <- {int(loop_closure.candidate_kf_id)}:"
              f" keyframes' ATE {a:.4f} -> {self.kf_ate(db):.4f} m",
              flush=True)

    def global_ba(self, orig, cur, db, settings, **k):
        waiting = [db.map_points[i] for i in self.never
                   if i in db.map_points and db.map_points[i].status
                   == self.status.NOT_TRIANGULATED]
        moved = sum(1 for mp in waiting if np.any(mp.position))
        self.at_origin = [mp for mp in db.map_points.values()
                          if mp.observations and never_triangulated(mp)]
        n_obs = sum(len(mp.observations) for mp in self.at_origin)
        a = self.kf_ate(db)
        self.db = db
        self.in_global = True
        try:
            orig(cur, db, settings, **k)
        finally:
            self.in_global = False
        g = self.globals[-1]
        c0, c1, acc = g.steps()
        print(f"global BA at frame {self.frame}, keyframe {int(cur)}: K "
              f"{g.nk} ({g.K} padded), M {g.nm} ({g.M} padded) of the map's "
              f"{len(db.map_points)}; {len(self.at_origin)} observed points "
              f"never triangulated at the origin ({n_obs} observations), "
              f"{moved} of the {len(waiting)} never triangulated when the "
              f"loop closed moved off it by the correction; {g.branch}, "
              f"cost {c0:.6g} -> "
              f"{c1:.6g}, {acc} of {g.iterations} LM steps accepted; "
              f"keyframes' ATE {a:.4f} -> {self.kf_ate(db):.4f} m",
              flush=True)

    def solve(self, orig, builder, iterations, *a, **k):
        if not self.in_global:
            return orig(builder, iterations, *a, **k)
        problem = builder.build()
        g = GlobalTrace(problem, iterations, builder)
        self.globals.append(g)
        solve = lambda: orig(builder, iterations, *a, **k)  # noqa: E731
        if self.args.package == "jax":
            import jax.numpy as jnp
            res = record_cg(self.ba, "solve_ba_fused", g, solve)
            jp = type(problem)(*(jnp.asarray(t) for t in problem))
            g.costs = jax_costs(self.ba, jp, iterations, g.cg)
            print(f"  (the JAX LM traced again for its costs: final "
                  f"{g.steps()[1]:.6g} against the solve's "
                  f"{float(np.asarray(res.cost)):.6g})", flush=True)
        else:
            res, g.costs = record_cg(self.ba, "solve_ba_eager", g,
                                     lambda: record_costs(self.ba, solve))
        if self.on_global is not None:
            self.on_global(builder, problem, g)
        return res

    def local_ba(self, orig, keyframe, workspace, db, *a, **k):
        before = {i: _centre(kf.pose_cw) for i, kf in db.keyframes.items()}
        ate0 = self.kf_ate(db)
        out = orig(keyframe, workspace, db, *a, **k)
        moved = max((np.linalg.norm(_centre(kf.pose_cw) - before[i])
                     for i, kf in db.keyframes.items() if i in before),
                    default=0.0)
        ate1 = self.kf_ate(db)
        if abs(ate1 - ate0) > 0.005 or moved > 0.05:
            print(f"  local BA at keyframe {int(keyframe.id)}: keyframes' "
                  f"ATE {ate0:.4f} -> {ate1:.4f} m, a camera moved "
                  f"{moved:.4f} m", flush=True)
        return out

    # ------------------------------------------------------------------

    def run(self, **extra):
        """The whole session through the scene's tool; its result dict."""
        a = self.args
        os.makedirs(OUT_DIR, exist_ok=True)
        if a.scene == "room":
            kw = {} if a.package == "jax" else {"device": a.device}
            return self.tool.run(
                n_frames=a.frames, drift=a.drift, progress=False,
                out=os.path.join(OUT_DIR, "trace_euroc_ba.csv"), **kw, **extra)
        kw = dict(n_frames=a.frames, drift=a.drift, drift_yaw=a.drift_yaw,
                  seed=a.seed, radius=a.radius or self.tool.RADIUS,
                  blackout=(a.frames // 2, a.frames // 2 + 4),
                  reloc=not a.no_reloc, progress=False)
        # one directory a run, so that runs side by side keep their maps
        # and trajectories apart
        run_dir = os.path.join(OUT_DIR, f"trace_{a.package}_{a.frames}_"
                               f"{kw['radius']:g}_{a.seed}")
        os.makedirs(run_dir, exist_ok=True)
        if a.package == "jax":
            # the original writes its map and trajectory to fixed /tmp
            # paths; send them to the run's directory
            join = os.path.join
            self.patch(self.tool, "os", types.SimpleNamespace(
                path=types.SimpleNamespace(join=lambda p, *rest: join(
                    run_dir if p == "/tmp" else p, *rest))))
            return self.tool.run(**kw)
        return self.tool.drive(
            **kw, map_path=os.path.join(run_dir, "kitti_synth_map.npz"),
            device=a.device)[0]

    def replay_local(self):
        """Capture keyframe ``--replay-kf``'s two-stage local BA and solve it
        again in f32 and in f64 on the card and the CPU; then split it and
        solve it again from the truth (``truth_replay``)."""
        import torch

        ba, helpers, args = self.ba, self.helpers, self.args
        cur, captured, seen, last = [None], {}, [], {}
        lba, two = helpers.local_bundle_adjust, ba.solve_ba_two_stage
        create = helpers.create_new_map_points
        build = self.bamod._ProblemBuilder.build

        def new_points(keyframe, adjacent, db, *a, **k):
            before = set(db.map_points)
            create(keyframe, adjacent, db, *a, **k)
            last["new"] = set(db.map_points) - before

        def built(builder):
            last["builder"] = builder
            return build(builder)

        def local_ba(keyframe, workspace, db, *a, **k):
            cur[0] = int(keyframe.id)
            last["db"] = db
            return lba(keyframe, workspace, db, *a, **k)

        def two_stage(p, s2, slot, info, **k):
            seen.append(cur[0])
            if cur[0] == args.replay_kf:
                captured.update(p=type(p)(*(t.cpu() for t in p)),
                                s2=s2.cpu(), slot=slot.cpu(), info=info.cpu(),
                                **last, **k)
                raise Captured
            return two(p, s2, slot, info, **k)

        self.patch(helpers, "create_new_map_points", new_points)
        self.patch(self.bamod._ProblemBuilder, "build", built)
        self.patch(helpers, "local_bundle_adjust", local_ba)
        self.patch(ba, "solve_ba_two_stage", two_stage)
        try:
            self.run()
        except Captured:
            pass
        finally:
            self.close()
        assert captured, (f"keyframe {args.replay_kf} ran no two-stage local"
                          f" BA; these did: {seen}")
        p, s2, slot, info = (captured[k] for k in ("p", "s2", "slot", "info"))
        c0 = np.array([_centre(T) for T in p.poses[0].numpy()])
        devices = ("cuda", "cpu") if torch.cuda.is_available() else ("cpu",)
        for dev in devices:
            for dtype in (torch.float32, torch.float64):
                cast = lambda t: (t.to(dev, dtype) if t.is_floating_point()
                                  else t.to(dev))
                res = ba.two_stage_lm(
                    type(p)(*(cast(t) for t in p)), cast(s2), cast(slot),
                    cast(info), iterations=captured["iterations"],
                    cg_iters=captured["cg_iters"])
                c1 = np.array([_centre(T) for T in
                               res.poses[0].double().cpu().numpy()])
                print(f"replay keyframe {args.replay_kf} (K "
                      f"{p.poses.shape[1]}, M {p.points.shape[1]}) on {dev}, "
                      f"{str(dtype)[6:]}: a camera moved "
                      f"{np.linalg.norm(c1 - c0, axis=1).max():.4f} m; final "
                      f"cost {float(res.cost[0]):.6g}", flush=True)
        return self.truth_replay(captured)

    def truth_replay(self, captured):
        """Keyframe ``--replay-kf``'s local BA, split and then solved from
        the truth on the CPU in f64 (``--save`` writes the problem, its
        stage-2 arguments and the window's true poses). The split: the
        newest keyframe's camera-centre error, the along-track part of its
        step from the keyframe before it, and the window's Sim3-fit scale,
        before the BA, after stage 1 and after stage 2; the new points' and
        the window
        points' depths against the same points triangulated through the true
        poses; the reprojection residuals at the truth by pyramid level. From
        the truth (true poses, points triangulated through them): both
        stages as the mapper runs them, then stage 2 alone with every term,
        without the odometry edges, without the anchor, with the odometry
        edges' measurements at the truth, at the truth but for their
        measured sideways (camera x) part, and at the truth +- 5 mm
        sideways a step. Returns {name: (newest keyframe's error, its
        step's along-track error, window scale)}."""
        import torch

        ba, args = self.ba, self.args
        b, db = captured["builder"], captured["db"]
        nk, nm = len(b.kf_ids), len(b.mp_ids)
        P = {f: t[0].double().numpy() if t.is_floating_point()
             else t[0].numpy() for f, t in captured["p"]._asdict().items()}
        slot = int(captured["slot"].reshape(-1)[0])
        kf_ids = [int(k) for k in b.kf_ids]
        prev = max((i for i in range(nk) if kf_ids[i] < kf_ids[slot]),
                   key=lambda i: kf_ids[i])
        frames = [self.frame_of(db.keyframes[k].t) for k in b.kf_ids]
        truth = self.gt_poses[frames]
        tc = np.array([_centre(T) for T in truth])
        if args.save:
            np.savez_compressed(
                args.save, truth=truth, frames=frames,
                stage2_pose_fixed=captured["s2"][0].numpy(),
                anchor_slot=slot, anchor_sqrt_info=captured["info"][0].numpy(),
                iterations=captured["iterations"],
                cg_iters=captured["cg_iters"],
                **{f: t[0].numpy()
                   for f, t in captured["p"]._asdict().items()})
        f = frames[slot]
        ahead = self.gt[min(f + 1, len(self.gt) - 1)] - self.gt[max(f - 1, 0)]
        ahead = ahead / np.linalg.norm(ahead)

        def measure(poses):
            c = np.array([_centre(T) for T in poses[:nk]])
            step = (c[slot] - c[prev]) - (tc[slot] - tc[prev])
            return (float(np.linalg.norm(c[slot] - tc[slot])),
                    float(step @ ahead), sim3_scale(c, tc))

        def show(name, poses, cost=None):
            err, along, scale = out[name] = measure(poses)
            print(f"  {name}: newest keyframe off by {err:.4f} m, its step "
                  f"{along:+.5f} m along the track, window scale "
                  f"{scale:.5f}" + ("" if cost is None else
                                    f", final cost {cost:.6g}"), flush=True)

        def solve(over, stages="both", anchor=True):
            """``stages``: "1" (stage 1), "both" (as the mapper runs them)
            or "2" (stage 2 alone, anchored at its start unless not
            ``anchor``), on P with the fields of ``over``."""
            q = ba.BAProblem(**{
                k: torch.from_numpy(np.ascontiguousarray(v))[None]
                for k, v in {**P, **over}.items()})
            it, cg = captured["iterations"], captured["cg_iters"]
            info = captured["info"].double()
            if stages == "both":
                res = ba.two_stage_lm(q, captured["s2"], captured["slot"],
                                      info, iterations=it, cg_iters=cg)
            else:
                if stages == "2":
                    q = q._replace(
                        pose_fixed=captured["s2"],
                        pr_idx=captured["slot"].to(torch.int64)[:, None],
                        pr_meas=q.poses[:, slot:slot + 1],
                        pr_sqrt_info=info[:, None],
                        pr_valid=torch.tensor([[anchor]]))
                res = ba.lm_run(q, it, cg, ba.HUBER_DELTA, 1e-4)
            return res.poses[0].numpy(), float(res.cost[0])

        out = {}
        print(f"split keyframe {args.replay_kf}'s local BA (K {nk}, M {nm}; "
              f"true frames {frames[0]}-{frames[-1]}):", flush=True)
        show("before the BA", P["poses"])
        show("after stage 1", *solve({}, "1"))
        show("after stage 2", *solve({}))

        # depths against the points triangulated through the true poses
        obs = (P["obs_kf"], P["obs_mp"], P["obs_meas"], P["obs_sqrt_info"],
               P["obs_valid"])
        Xt, ok = triangulate_at(np.concatenate([truth, P["poses"][nk:]]),
                                P["points"], *obs)
        ok[nm:] = False
        Te, Tt = P["poses"][slot], truth[slot]

        def depth_ratio(est, true):
            ze = est @ Te[2, :3] + Te[2, 3]
            zt = true @ Tt[2, :3] + Tt[2, 3]
            return float(np.median(ze / zt)) if len(ze) else float("nan")

        # the new points (two observations, not yet in the BA) through
        # their keyframes' true poses
        new = [db.map_points[i] for i in sorted(captured.get("new", ()))
               if i in db.map_points]
        est = np.array([mp.position for mp in new]).reshape(-1, 3)
        true = est[:0]
        if new:
            kfs = sorted({k for mp in new for k in mp.observations})
            at = {k: i for i, k in enumerate(kfs)}
            rows = [(j, at[k], int(kp)) for j, mp in enumerate(new)
                    for k, kp in sorted(mp.observations.items())]
            j, kf_at, kp = (np.array(c) for c in zip(*rows))
            bear = np.array([db.keyframes[kfs[a]].shared.bearings[k]
                             for a, k in zip(kf_at, kp)])
            Xn, okn = triangulate_at(
                self.gt_poses[[self.frame_of(db.keyframes[k].t)
                               for k in kfs]], est, kf_at, j,
                bear[:, :2] / bear[:, 2:3], np.ones(len(j)),
                np.ones(len(j), bool))
            est, true = est[okn], Xn[okn]
        seen_now = np.unique(P["obs_mp"][P["obs_valid"]
                                         & (P["obs_kf"] == slot)])
        seen_now = seen_now[ok[seen_now]]
        window = np.flatnonzero(ok)
        for name, e, t in (
                ("new points", est, true),
                ("points the newest keyframe sees", P["points"][seen_now],
                 Xt[seen_now]),
                ("window points", P["points"][window], Xt[window])):
            print(f"  {name}: median depth in the newest keyframe "
                  f"{depth_ratio(e, t):.5f} x the truth's ({len(e)} "
                  f"points)", flush=True)

        # reprojection residuals at the truth, by pyramid level (pixels)
        o = np.flatnonzero(P["obs_valid"] & ok[P["obs_mp"]])
        T = truth[P["obs_kf"][o]]
        pc = np.einsum("nij,nj->ni", T[:, :3, :3], Xt[P["obs_mp"][o]]) \
            + T[:, :3, 3]
        kf0 = db.keyframes[b.kf_ids[0]]
        focal = float(kf0.shared.camera.get_focal_length())
        res_px = (pc[:, :2] / pc[:, 2:3] - P["obs_meas"][o]) * focal
        level = np.array([
            db.keyframes[b.kf_ids[k]].shared.octave[
                int(np.flatnonzero(db.keyframes[b.kf_ids[k]].map_points
                                   == int(b.mp_ids[m]))[0])]
            for k, m in zip(P["obs_kf"][o], P["obs_mp"][o])])
        for lv in np.unique(level):
            sel = level == lv
            mx, my = res_px[sel].mean(0)
            print(f"  level {lv}: {int(sel.sum())} observations, mean "
                  f"residual at the truth ({mx:+.4f}, {my:+.4f}) px, RMS "
                  f"{np.sqrt((res_px[sel] ** 2).sum(1).mean()):.4f}",
                  flush=True)

        # from the truth
        keep = ok & ~P["points_fixed"]
        start = {"poses": np.concatenate([truth, P["poses"][nk:]]),
                 "points": np.where(keep[:, None], Xt, P["points"]),
                 "points_fixed": P["points_fixed"] | ~ok,
                 "obs_valid": P["obs_valid"] & ok[P["obs_mp"]]}
        print(f"from the truth ({int(keep[:nm].sum())} of {nm} points "
              f"triangulated through the true poses):", flush=True)
        show("the truth", start["poses"])
        show("both stages as the mapper runs them", *solve(start))
        exact = P["pe_meas"].copy()
        for e in np.flatnonzero(P["pe_valid"]):
            a, bb = P["pe_a"][e], P["pe_b"][e]
            exact[e] = start["poses"][bb] @ np.linalg.inv(start["poses"][a])

        def sideways(x):
            # the true edges with a sideways (camera x) part: the measured
            # one (None) or x metres a step
            m = exact.copy()
            m[:, 0, 3] = P["pe_meas"][:, 0, 3] if x is None \
                else m[:, 0, 3] + x
            return {"pe_meas": m}

        valid = P["pe_valid"]
        side = (P["pe_meas"] - exact)[valid, 0, 3]
        print(f"  the odometry edges' sideways error: mean "
              f"{1e3 * side.mean():+.3f} mm a step over {int(valid.sum())} "
              f"edges", flush=True)
        for name, over in (
                ("every term", {}),
                ("no odometry edges", {"pe_valid": np.zeros_like(valid)}),
                ("no anchor", None),
                ("odometry edges at the truth", {"pe_meas": exact}),
                ("odometry edges at the truth but their measured sideways "
                 "part", sideways(None)),
                ("odometry edges at the truth + 5 mm sideways",
                 sideways(0.005)),
                ("odometry edges at the truth - 5 mm sideways",
                 sideways(-0.005))):
            show(f"stage 2 alone, {name}",
                 *solve({**start, **(over or {})}, "2", over is not None))
        return out

    def replay_global(self):
        """Capture the first global BA's problem, stop the session, and
        solve the problem again on the card and the CPU at each budget."""
        import torch

        from slam_tpu_torch.pipeline.bundle_adjustment import (
            _problem_to_device)

        captured, a = {}, self.args

        def capture(builder, problem, g):
            db = self.db
            kfs = [db.keyframes[i] for i in builder.kf_ids]
            captured.update(problem=problem, g=g, truth=[
                self.gt[self.frame_of(kf.t)] for kf in kfs])
            raise Captured

        if a.load:
            z = np.load(a.load)
            problem = self.ba.BAProblem(*(z[f] for f in
                                          self.ba.BAProblem._fields))
            K, M = problem.poses.shape[0], problem.points.shape[0]
            captured.update(problem=problem, truth=list(z["truth"]),
                            g=GlobalTrace(problem, int(z["iterations"]),
                                          cg=self.ba.pick_global_cg_iters(
                                              K, M)))
        else:
            self.on_global = capture
            try:
                self.run()
            except Captured:
                pass
        assert captured, "the session ran no global BA"
        problem, g, truth = (captured[k] for k in ("problem", "g", "truth"))
        if a.save:
            np.savez_compressed(a.save, truth=np.asarray(truth),
                                iterations=g.iterations, **problem._asdict())
        n = len(truth)
        ref = self.ba.pick_cg_iters(g.K, g.M)
        budgets = ([int(b) for b in a.budgets.split(",")]
                   if a.budgets else [ref, 4 * ref, g.cg])
        steps = ([int(i) for i in a.iterations.split(",")]
                 if a.iterations else [g.iterations])
        start = aligned_ate([_centre(T) for T in problem.poses[:n]], truth)
        print(f"replay the global BA of "
              f"{a.load or f'frame {self.frame}'}: K {n} ({g.K} "
              f"padded), M {g.nm} ({g.M} padded), {g.iterations} LM steps; "
              f"keyframes' ATE before it {start:.4f} m", flush=True)
        devices = a.devices.split(",") if a.devices else (
            ("cuda", "cpu") if torch.cuda.is_available() else ("cpu",))
        for dev in devices:
            for cg in budgets:
                if cg == 0 and self.ba.pick_global_cg_iters(g.K, g.M):
                    print(f"  {dev}, dense Schur: left out, K * M "
                          f"{g.K * g.M} > {self.ba.GLOBAL_DENSE_MAX_KM}")
                    continue
                for it in steps:
                    self.replay_one(problem, truth, dev, cg, it)

    def replay_one(self, problem, truth, dev, cg, iterations):
        """Solve ``problem`` on ``dev`` with ``iterations`` LM steps of PCG
        budget ``cg`` (0: dense Schur); print what it gives."""
        import torch

        from slam_tpu_torch.pipeline.bundle_adjustment import (
            _problem_to_device)

        n = len(truth)
        p = _problem_to_device(problem, torch.device(dev))
        card = p.poses.is_cuda
        if card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, costs = record_costs(self.ba, lambda: self.ba.solve_ba_eager(
            p, iterations=iterations, cg_iters=cg))
        poses = res.poses[0].double().cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
        # the solve's own peak on the card, above the problem's tensors
        peak = (f", peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.3f}"
                f" GB allocated" if card else "")
        r = GlobalTrace(problem, iterations, cg=cg)
        r.costs = costs
        c0, c1, acc = r.steps()
        ate = aligned_ate([_centre(T) for T in poses[:n]], truth)
        print(f"  {dev}, {r.branch}, {iterations} LM steps: keyframes' ATE "
              f"{ate:.4f} m, cost {c0:.6g} -> {c1:.6g}, {acc} accepted, "
              f"{ms:.1f} ms{peak}", flush=True)


class Captured(Exception):
    pass


if __name__ == "__main__":
    main()
