#!/usr/bin/env python
"""Vocabulary domain transfer through the port: revisit recall against
perturbation.

The port's twin of ``tools/eval_vocab_transfer.py``. The shipped retrieval
vocabulary (``slam_tpu_torch/data/vocab_65536.npz``) was trained on
descriptors of the dot-field renderer; does its revisit recall transfer to
texture domains it never saw? Each domain indexes one lap of keyframes
(``OrbExtractor`` words -> ``BowIndex``), then queries every pose again
under a perturbation level:

  geometric   -- lateral camera offset (m, camera-x) + yaw offset (deg)
  photometric -- exposure gain, brightness bias, additive Gaussian noise

from L0 (exact re-render) to L3, and reports recall, the mean candidate
count and the genuine-revisit cosine scores.

Domains:
  dots    -- the dot-field world of bench.py (the training domain)
  room    -- the EuRoC-class textured room, held-out seed
  tiled   -- the repeating-texture room
  street  -- the KITTI-class street canyon

Usage:
  python tools/torch_eval_vocab_transfer.py [--lap 32] [--seed 100]
      [--domains dots room tiled street] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from slam_tpu_torch.geometry import se3

# (lateral m, yaw deg, gain, bias, noise sigma) per perturbation level
LEVELS = [
    ("L0_exact", 0.0, 0.0, 1.0, 0.0, 0.0),
    ("L1_mild", 0.10, 4.0, 0.95, 5.0, 3.0),
    ("L2_moderate", 0.25, 10.0, 0.90, 10.0, 5.0),
    ("L3_strong", 0.50, 20.0, 0.85, -15.0, 8.0),
]


def _perturb_pose(pose_cw, dx, dyaw_deg):
    R = pose_cw[:3, :3]
    t = pose_cw[:3, 3]
    c = -R.T @ t
    c2 = c + R.T @ np.array([dx, 0.0, 0.0])
    dR = se3.so3_exp(np.array([0.0, np.radians(dyaw_deg), 0.0]))
    R2 = dR @ R
    out = np.eye(4)
    out[:3, :3] = R2
    out[:3, 3] = -R2 @ c2
    return out


def _photometric(img, gain, bias, sigma, rng):
    out = img.astype(np.float32) * gain + bias
    if sigma > 0:
        out = out + rng.normal(0.0, sigma, img.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _dots_domain(lap, seed):
    """Training-domain dot world; queries re-render at perturbed poses."""
    from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                                render_frame)

    cam = default_camera(640, 480)
    world = make_world(n_frames=lap, n_landmarks=700, seed=seed,
                       trajectory="loop", lap_frames=lap, camera=cam)
    rng = np.random.default_rng(seed + 1)
    patches = rng.integers(40, 255, (700, 11, 11)).astype(np.uint8)
    index_frames = [render_frame(world, patches, i) for i in range(lap)]

    def query(i, dx, dyaw):
        orig = world.poses_cw[i]
        world.poses_cw[i] = _perturb_pose(orig, dx, dyaw)
        try:
            return render_frame(world, patches, i)
        finally:
            world.poses_cw[i] = orig

    return index_frames, query, 640, 480


def _room_domain(lap, seed, tile):
    from torch_run_euroc_synthetic import (CAM, circle_pose_cw, make_scene,
                                           render)

    scene = make_scene(seed, tile=tile)
    poses = [circle_pose_cw(2.0 * np.pi * i / lap) for i in range(lap)]
    index_frames = [render(scene, p) for p in poses]

    def query(i, dx, dyaw):
        return render(scene, _perturb_pose(poses[i], dx, dyaw))

    return index_frames, query, CAM.width, CAM.height


def _street_domain(lap, seed):
    from torch_run_euroc_synthetic import render
    from torch_run_kitti_synthetic import (CAM, FPS, SPEED, circle_pose_cw,
                                           make_street_scene)

    radius = lap * (SPEED / FPS) / (2.0 * np.pi)
    f = radius / 80.0
    scene = make_street_scene(seed, outer=95.0 * f, inner=52.0 * f)
    poses = [circle_pose_cw(2.0 * np.pi * i / lap, radius=radius)
             for i in range(lap)]
    index_frames = [render(scene, p, cam=CAM) for p in poses]

    def query(i, dx, dyaw):
        return render(scene, _perturb_pose(poses[i], dx, dyaw), cam=CAM)

    return index_frames, query, CAM.width, CAM.height


DOMAINS = {"dots": _dots_domain,
           "room": lambda lap, seed: _room_domain(lap, seed, tile=0),
           "tiled": lambda lap, seed: _room_domain(lap, seed, tile=8),
           "street": _street_domain}


def eval_domain(name, index_frames, query_fn, width, height, lap,
                vocab_path=None, seed=0, device="cuda"):
    """Rows of recall and scores, one per perturbation level, with the keys
    of ``tools/eval_vocab_transfer.eval_domain``'s rows."""
    from slam_tpu_torch.ids import CURRENT_MAP_ID, KfId
    from slam_tpu_torch.map.keyframe import Keyframe
    from slam_tpu_torch.map.mapdb import MapDB
    from slam_tpu_torch.ops.bow import BowIndex
    from slam_tpu_torch.ops.frontend import OrbExtractor
    from slam_tpu_torch.params import (Parameters, ParametersSlam,
                                       StaticSettings)

    kw = {"maxKeypoints": 600}
    if vocab_path:
        kw["vocabularyPath"] = vocab_path
    ps = ParametersSlam(**kw)
    settings = StaticSettings(Parameters(slam=ps))
    ex = OrbExtractor(settings, width, height, max_tracked=8, device=device)
    index = BowIndex(ps, device=device)
    db = MapDB()
    no_ids = np.zeros(0, np.int64)
    no_pts = np.zeros((0, 2), np.float32)

    def make_kf(img, i):
        res = ex.detect_and_extract(img, no_pts, no_ids)
        kf = Keyframe()
        kf.id = KfId(i)
        kf.shared.descriptors = np.asarray(res.descriptors)[
            np.asarray(res.valid)]
        index.transform(kf.shared)
        return kf

    t0 = time.time()
    indexed = []
    for i, img in enumerate(index_frames):
        kf = make_kf(img, i)
        index.add(kf, CURRENT_MAP_ID)
        indexed.append(kf)

    rng = np.random.default_rng(seed + 77)
    rows = []
    for (lname, dx, dyaw, gain, bias, sigma) in LEVELS:
        hits = total = 0
        n_cands = []
        genuine_scores = []
        for i in range(lap):
            img = _photometric(query_fn(i, dx, dyaw), gain, bias, sigma, rng)
            qkf = make_kf(img, lap + i)
            sims = index.get_bow_similar(db, [], qkf)
            got = {int(s.map_kf.kf_id) for s in sims}
            n_cands.append(len(got))
            total += 1
            ok = any(abs(g - i) <= 2 or abs(g - i) >= lap - 2 for g in got)
            hits += ok
            # raw cosine score against the true-revisit keyframe
            genuine_scores.append(float(
                index.score(qkf.shared, indexed[i].shared)))
        rows.append({
            "domain": name, "level": lname, "lap": lap,
            "recall": round(hits / total, 3),
            "mean_candidates": round(float(np.mean(n_cands)), 1),
            "min_genuine_score": round(float(np.min(genuine_scores)), 3),
            "mean_genuine_score": round(float(np.mean(genuine_scores)), 3),
            "wall_s": round(time.time() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lap", type=int, default=32)
    ap.add_argument("--seed", type=int, default=100)  # held-out from training
    ap.add_argument("--domains", nargs="+", choices=list(DOMAINS),
                    default=list(DOMAINS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    all_rows = []
    for d in args.domains:
        idx, q, w, h = DOMAINS[d](args.lap, args.seed)
        all_rows.extend(eval_domain(d, idx, q, w, h, args.lap,
                                    seed=args.seed, device=args.device))

    print("\n| domain | level | recall | mean cands | min genuine score |")
    print("|---|---|---|---|---|")
    for r in all_rows:
        print(f"| {r['domain']} | {r['level']} | {r['recall']:.2f} | "
              f"{r['mean_candidates']} | {r['min_genuine_score']:.3f} |")


if __name__ == "__main__":
    main()
