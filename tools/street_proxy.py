#!/usr/bin/env python
"""The KITTI-class street's drift proxy, for the JAX package of any commit.

Runs ``run(...)`` of ``tools/run_kitti_synthetic.py`` from TREE (a commit
unpacked with ``git archive <sha> | tar -x -C TREE`` into a git-ignored
directory such as ``build/bisect/<sha>``) on the CPU, with TREE's own
``slam_tpu``, at the tool's defaults but ``--frames``/``--seed`` and without
the relocation pass (the blackout stays at frames N/2 to N/2 + 4, as the
tool places it). The tool's map and trajectory, which it writes to fixed
``/tmp`` paths, go to ``--out`` instead, so runs side by side keep them
apart. Prints one JSON object: the tool's result, and

  * ``kf_err_<i>``/``odo_err_<i>`` at frames 19, 39, ... (every 20): the
    newest keyframe's camera-centre error and the odometry's, in metres;
  * ``sim3_scale_0_99``/``sim3_scale_all``: the scale of the least-squares
    similarity (``sim3_scale``) that takes the true camera centres of
    keyframes 0-99 (all keyframes) onto the trajectory the tool wrote;
    below 1 the trajectory is small.

Usage:
  python tools/street_proxy.py TREE [--frames 120] [--seed 0] [--out DIR]
"""
import argparse
import json
import os
import sys
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sim3_scale(centres, truth):
    """Scale of the least-squares similarity (Umeyama) that takes the true
    camera centres onto the estimated ones: below 1 the estimate is small."""
    e = np.asarray(centres, np.float64)
    r = np.asarray(truth, np.float64)
    e, r = e - e.mean(0), r - r.mean(0)
    U, S, Vt = np.linalg.svd(e.T @ r / len(e))
    d = np.sign(np.linalg.det(U @ Vt))
    return float((S[0] + S[1] + d * S[2]) / (r ** 2).sum(1).mean())


def track_errors(mapper_cls, truth, fps, out):
    """Wrap ``mapper_cls.advance`` so that at every 20th frame (19, 39, ...)
    it writes the newest keyframe's camera-centre error and the odometry's
    against ``truth`` (the true centres by frame) into ``out`` as
    ``kf_err_<i>``/``odo_err_<i>``. Returns the function that takes the
    wrapper out again."""
    advance = mapper_cls.advance

    def centre(T):
        return -T[:3, :3].T @ T[:3, 3]

    def traced(mapper, mi):
        res = advance(mapper, mi)
        i = int(round(mi.t * fps))
        if (i + 1) % 20 == 0 and mapper.map_db.keyframes:
            kf = mapper.map_db.latest_keyframe()
            out[f"kf_err_{i}"] = float(np.linalg.norm(
                centre(kf.pose_cw) - truth[int(round(kf.t * fps))]))
            out[f"odo_err_{i}"] = float(np.linalg.norm(
                centre(mi.pose_trail[0].pose_cw) - truth[i]))
        return res

    mapper_cls.advance = traced
    return lambda: setattr(mapper_cls, "advance", advance)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="directory for the tool's map and trajectory "
                         "(default build/street_proxy/<tree>_<frames>_<seed>)")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    out = args.out or os.path.join(
        ROOT, "build", "street_proxy",
        f"{os.path.basename(tree)}_{args.frames}_{args.seed}")
    os.makedirs(out, exist_ok=True)
    # TREE's package and tools, never the checkout's
    sys.path[:0] = [os.path.join(tree, "tools"), tree]
    import jax
    jax.config.update("jax_platforms", "cpu")
    import run_kitti_synthetic as tool
    from slam_tpu.pipeline import mapper as mapper_mod
    assert tool.__file__.startswith(tree), tool.__file__

    join = os.path.join
    tool.os = types.SimpleNamespace(path=types.SimpleNamespace(
        join=lambda p, *rest: join(out if p == "/tmp" else p, *rest)))
    _, poses = tool.make_sequence(args.frames, radius=tool.RADIUS)
    truth = np.array([-T[:3, :3].T @ T[:3, 3] for T in poses])
    proxy = {}
    track_errors(mapper_mod.Mapper, truth, tool.FPS, proxy)
    res = tool.run(n_frames=args.frames, seed=args.seed, reloc=False,
                   progress=False,
                   blackout=(args.frames // 2, args.frames // 2 + 4))
    est = np.genfromtxt(join(out, "kitti_synth_traj.csv"), delimiter=",")
    frame = np.rint(est[:, 0] * tool.FPS).astype(int)
    first = frame <= 99
    proxy["sim3_scale_0_99"] = sim3_scale(est[first, 1:4],
                                          truth[frame[first]])
    proxy["sim3_scale_all"] = sim3_scale(est[:, 1:4], truth[frame])
    res.update(proxy)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
