#!/usr/bin/env python
"""Default-preset accuracy matrix of the port's device-resident VO.

The port's twin of ``tools/sweep_device_vo.py``: does ``slam_tpu_torch``'s
``BatchedDeviceVO`` beat the odometry it is fed at every drift level, on the
EuRoC-class room and on the repeating-texture room (``make_scene(tile=8)``)?
It sweeps

  world    : distinct textures (tile=0) | repeating textures (tile=8)
  drift    : odometry random-walk sigma per frame
  variant  : default | default+lowe0.9 | default+window8 | frozen preset |
             the odometry-prior and observation-weight experiments

Frames are rendered once per world (drift only perturbs the odometry
deltas). Prints one JSON line per cell and a markdown summary table.

Usage:
  python tools/torch_sweep_device_vo.py [--frames N] [--sequences S]
      [--drifts D ...] [--tiles T ...] [--variants V ...] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_run_device_vo_euroc import ate, drifted_odometry
from torch_run_euroc_synthetic import (CAM, make_scene, make_sequence,
                                       render)

from slam_tpu_torch.geometry import se3


VARIANTS = {
    "default": {},
    "default+lowe0.9": {"match_lowe_ratio": 0.9},
    "default+window8": {"window": 8},
    "frozen": {"stale_age": None, "max_depth_step": 0.0},  # stale_age->N
    # odometry-prior weighting experiments on the window8 base
    "w8+odo300": {"window": 8, "odom_pos_weight": 300.0,
                  "odom_rot_weight": 3000.0},
    "w8+odo1000": {"window": 8, "odom_pos_weight": 1000.0,
                   "odom_rot_weight": 10000.0},
    "w8+obs0.5": {"window": 8, "obs_weight_scale": 0.5},
    "w8+odo300+obs0.5": {"window": 8, "odom_pos_weight": 300.0,
                         "odom_rot_weight": 3000.0, "obs_weight_scale": 0.5},
    "w8+lowe0.9": {"window": 8, "match_lowe_ratio": 0.9},
    "w8+maturity": {"window": 8, "window_maturity_weight": True},
    "w8+maturity+odo300": {"window": 8, "window_maturity_weight": True,
                           "odom_pos_weight": 300.0,
                           "odom_rot_weight": 3000.0},
}


def sweep(frames=96, sequences=2, chunk=8, seed=0,
          drifts=(0.0015, 0.004, 0.008), tiles=(0, 8),
          variants=tuple(VARIANTS), device="cuda"):
    """One row per (tile, drift, variant) cell, with the keys of the
    original's JSON lines."""
    from slam_tpu_torch.pipeline.device_vo import (BatchedDeviceVO,
                                                   DeviceVOConfig)

    n_frames = (frames // chunk) * chunk
    S = sequences
    rows = []
    for tile in tiles:
        # render once per world; gt poses shared by every cell
        t0 = time.perf_counter()
        world_seqs = []
        for s in range(S):
            scene = make_scene(seed + s, tile=tile)
            _, poses_cw = make_sequence(n_frames, seed + s)
            frames_s = np.stack([render(scene, poses_cw[i])
                                 for i in range(n_frames)])
            world_seqs.append((poses_cw, frames_s))
        print(f"# world tile={tile}: rendered {S}x{n_frames} frames "
              f"in {time.perf_counter() - t0:.0f}s", file=sys.stderr,
              flush=True)
        images = np.stack([w[1] for w in world_seqs])

        for drift in drifts:
            odo = [drifted_odometry(world_seqs[s][0], drift, seed + s)
                   for s in range(S)]
            deltas = np.stack([d for _, d in odo])
            for name in variants:
                over = dict(VARIANTS[name])
                if over.get("stale_age", 0) is None:
                    over["stale_age"] = n_frames
                cfg = DeviceVOConfig(width=CAM.width, height=CAM.height,
                                     lm_capacity=512, max_keypoints=600,
                                     **over)
                vo = BatchedDeviceVO(cfg, batch=S, camera=CAM, device=device)
                p0 = np.stack([w[0][0] for w in world_seqs]).astype(
                    np.float32)
                vo.reset(poses0_cw=p0)
                outs = []
                for c in range(n_frames // chunk):
                    sl = slice(c * chunk, (c + 1) * chunk)
                    outs.append(vo.advance(images[:, sl], deltas[:, sl]))
                poses = np.concatenate([o.pose_cw.cpu().numpy()
                                        for o in outs], axis=1)
                ate_vo, ate_od = [], []
                for s in range(S):
                    gt_c = np.stack([se3.camera_center(p)
                                     for p in world_seqs[s][0]])
                    vo_c = np.stack([se3.camera_center(p) for p in poses[s]])
                    od_c = np.stack([se3.camera_center(p)
                                     for p in odo[s][0]])
                    ate_vo.append(ate(vo_c, gt_c))
                    ate_od.append(ate(od_c, gt_c))
                row = {"tile": tile, "drift": drift, "variant": name,
                       "ate_vo_m": round(float(np.mean(ate_vo)), 4),
                       "ate_odometry_m": round(float(np.mean(ate_od)), 4),
                       "beats_odometry":
                           bool(np.mean(ate_vo) < np.mean(ate_od))}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def table(rows, tiles, drifts, variants):
    """The markdown summary: one line per (world, drift), a column per
    variant (bold where it beats the odometry) and the odometry's ATE."""
    lines = ["| world | drift | " + " | ".join(variants) + " | odometry |",
             "|---|---|" + "---|" * (len(variants) + 1)]
    for tile in tiles:
        for drift in drifts:
            cells = {r["variant"]: r for r in rows
                     if r["tile"] == tile and r["drift"] == drift}
            od = next(iter(cells.values()))["ate_odometry_m"]
            name = "tiled" if tile else "euroc"
            vals = " | ".join(
                f"**{cells[v]['ate_vo_m']:.3f}**"
                if cells[v]["beats_odometry"] else
                f"{cells[v]['ate_vo_m']:.3f}" for v in variants)
            lines.append(f"| {name} | {drift} | {vals} | {od:.3f} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--sequences", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drifts", type=float, nargs="+",
                    default=[0.0015, 0.004, 0.008])
    ap.add_argument("--tiles", type=int, nargs="+", default=[0, 8])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rows = sweep(args.frames, args.sequences, args.chunk, args.seed,
                 args.drifts, args.tiles, args.variants, args.device)
    print("\n" + table(rows, args.tiles, args.drifts, args.variants))


if __name__ == "__main__":
    main()
