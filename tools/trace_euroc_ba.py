#!/usr/bin/env python
"""Trace the bundle adjustments of the EuRoC-class room session.

Runs ``run(n_frames, drift)`` of ``tools/torch_run_euroc_synthetic.py``
(``--package torch``, on ``--device``) or of ``tools/run_euroc_synthetic.py``
(``--package jax``, the JAX package on the CPU) and prints, against the
rendered ground truth:

  * every 20 frames: the keyframes' ATE (translation-aligned), the newest
    keyframe's camera-centre error and the odometry's;
  * each loop correction: the keyframes' ATE before and after it;
  * each global BA: K, M, the map points never triangulated when the
    loop closed (at the origin, status NOT_TRIANGULATED), their
    observations and how many the correction moved off the origin, the
    keyframes' ATE before and after;
  * each local BA that moves a camera more than 5 cm or the ATE by more
    than 5 mm.

``--replay-kf K`` (torch only) stops at keyframe K's local BA instead and
solves that problem again (``ops/ba.two_stage_lm``) on the card and on the
CPU in f32 and in f64, printing how far each moves the cameras and its
final cost.

Usage:
  python tools/trace_euroc_ba.py [--package torch|jax] [--frames 240]
      [--drift 0.004] [--device cuda|cpu] [--replay-kf K]
"""
import argparse
import importlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--drift", type=float, default=0.004)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replay-kf", type=int, default=None)
    args = ap.parse_args()
    pkg = "slam_tpu_torch" if args.package == "torch" else "slam_tpu"
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        tool = importlib.import_module("run_euroc_synthetic")
        kw = {}
    else:
        tool = importlib.import_module("torch_run_euroc_synthetic")
        kw = {"device": args.device}
    helpers = importlib.import_module(pkg + ".pipeline.mapper_helpers")
    mapper_mod = importlib.import_module(pkg + ".pipeline.mapper")
    closer = importlib.import_module(pkg + ".pipeline.loop_closer")
    status = importlib.import_module(pkg + ".map.map_point").MapPointStatus
    from slam_tpu_torch.pipeline.bundle_adjustment import never_triangulated
    if args.package == "jax":
        # the reference's audit raises a known false alarm (ROADMAP
        # section 3); audit its map with the port's
        mapper_mod.check_consistency = importlib.import_module(
            "slam_tpu_torch.pipeline.mapper_helpers").check_consistency

    times, poses = tool.make_sequence(args.frames, 0)
    gt = [_centre(p) for p in poses]
    frame_of = lambda t: int(round(t * 20.0))

    def kf_ate(db):
        e = np.array([_centre(kf.pose_cw) - gt[frame_of(kf.t)]
                      for kf in db.keyframes.values()])
        e -= e.mean(0)
        return float(np.sqrt((e ** 2).sum(1).mean()))

    def wrap(owner, name, fn):
        orig = getattr(owner, name)
        setattr(owner, name, lambda *a, **k: fn(orig, *a, **k))

    def advance(orig, self, mi):
        out = orig(self, mi)
        i = frame_of(mi.t)
        if (i + 1) % 20 == 0:
            kf = self.map_db.latest_keyframe()
            err = np.linalg.norm(_centre(kf.pose_cw) - gt[frame_of(kf.t)])
            odo = np.linalg.norm(_centre(mi.pose_trail[0].pose_cw) - gt[i])
            print(f"frame {i}: keyframes' ATE {kf_ate(self.map_db):.4f} m, "
                  f"newest keyframe {int(kf.id)} off by {err:.4f} m, "
                  f"odometry by {odo:.4f} m", flush=True)
        return out

    never = set()         # points never triangulated when a loop closed

    def correct(orig, self, current_kf, loop_closure):
        a = kf_ate(self.map_db)
        never.update(i for i, mp in self.map_db.map_points.items()
                     if never_triangulated(mp))
        orig(self, current_kf, loop_closure)
        print(f"loop correction at keyframe {int(current_kf.id)} <- "
              f"{int(loop_closure.candidate_kf_id)}: keyframes' ATE {a:.4f} "
              f"-> {kf_ate(self.map_db):.4f} m", flush=True)

    def global_ba(orig, cur, db, settings, **k):
        waiting = [db.map_points[i] for i in never if i in db.map_points
                   and db.map_points[i].status == status.NOT_TRIANGULATED]
        moved = sum(1 for mp in waiting if np.any(mp.position))
        n_obs = sum(len(mp.observations) for mp in waiting)
        a = kf_ate(db)
        orig(cur, db, settings, **k)
        print(f"global BA at keyframe {int(cur)}: K {len(db.keyframes)}, M "
              f"{len(db.map_points)}, {len(waiting)} points never "
              f"triangulated ({n_obs} observations), {moved} of them moved "
              f"off the origin by the "
              f"loop correction; keyframes' ATE {a:.4f} -> {kf_ate(db):.4f} "
              f"m", flush=True)

    def local_ba(orig, keyframe, workspace, db, *a, **k):
        before = {i: _centre(kf.pose_cw) for i, kf in db.keyframes.items()}
        ate0 = kf_ate(db)
        out = orig(keyframe, workspace, db, *a, **k)
        moved = max((np.linalg.norm(_centre(kf.pose_cw) - before[i])
                     for i, kf in db.keyframes.items() if i in before),
                    default=0.0)
        ate1 = kf_ate(db)
        if abs(ate1 - ate0) > 0.005 or moved > 0.05:
            print(f"  local BA at keyframe {int(keyframe.id)}: keyframes' "
                  f"ATE {ate0:.4f} -> {ate1:.4f} m, a camera moved "
                  f"{moved:.4f} m", flush=True)
        return out

    wrap(mapper_mod.Mapper, "advance", advance)
    wrap(closer.LoopCloser, "correct_loop", correct)
    wrap(helpers, "global_bundle_adjust", global_ba)
    wrap(helpers, "local_bundle_adjust", local_ba)
    if args.replay_kf is not None:
        assert args.package == "torch", "--replay-kf replays the port's BA"
        return replay(tool, helpers, args)
    out = os.path.join(ROOT, "build", "torch_tools", "trace_euroc_ba.csv")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    res = tool.run(n_frames=args.frames, drift=args.drift, progress=False,
                   out=out, **kw)
    print(json.dumps(res))


def replay(tool, helpers, args):
    """Capture keyframe ``args.replay_kf``'s two-stage local BA and solve
    it again in f32 and in f64 on the card and the CPU."""
    import torch

    from slam_tpu_torch.ops import ba

    cur, captured, seen = [None], {}, []
    lba = helpers.local_bundle_adjust

    def local_ba(keyframe, *a, **k):
        cur[0] = int(keyframe.id)
        return lba(keyframe, *a, **k)

    class Captured(Exception):
        pass

    def two_stage(p, s2, slot, info, **k):
        seen.append(cur[0])
        if cur[0] == args.replay_kf:
            captured.update(p=type(p)(*(t.cpu() for t in p)), s2=s2.cpu(),
                            slot=slot.cpu(), info=info.cpu(), **k)
            raise Captured
        return two(p, s2, slot, info, **k)

    two = ba.solve_ba_two_stage
    helpers.local_bundle_adjust, ba.solve_ba_two_stage = local_ba, two_stage
    try:
        tool.run(n_frames=args.frames, drift=args.drift, progress=False,
                 out=os.path.join(ROOT, "build", "trace_replay.csv"),
                 device=args.device)
    except Captured:
        pass
    finally:
        helpers.local_bundle_adjust, ba.solve_ba_two_stage = lba, two
    assert captured, (f"keyframe {args.replay_kf} ran no two-stage local "
                      f"BA; these did: {seen}")
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
            print(f"replay keyframe {args.replay_kf} (K {p.poses.shape[1]}, "
                  f"M {p.points.shape[1]}) on {dev}, {str(dtype)[6:]}: a "
                  f"camera moved {np.linalg.norm(c1 - c0, axis=1).max():.4f}"
                  f" m; final cost {float(res.cost[0]):.6g}", flush=True)


if __name__ == "__main__":
    main()
