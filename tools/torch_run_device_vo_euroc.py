#!/usr/bin/env python
"""Device-resident VO accuracy on the EuRoC-class room, through the port.

The port's twin of ``tools/run_device_vo_euroc.py``: S sequences of the
rendered room (``tools/torch_run_euroc_synthetic.py``) run batched through
``slam_tpu_torch``'s ``BatchedDeviceVO`` with drift-injected odometry deltas
as the motion prior, and the VO trajectory's ATE RMSE is compared with the
raw drifted odometry's. ``--window 8`` adds the sliding-window local BA;
``--slam`` runs ``DeviceSlam`` (in-scan retrieval, host closure consumer,
rebase) and takes the ATE of the closure-corrected trajectory.

Usage:
  python tools/torch_run_device_vo_euroc.py [--frames N] [--sequences S]
      [--drift SIGMA] [--chunk T] [--window K] [--preset frozen|default]
      [--slam] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_run_euroc_synthetic import (CAM, make_scene, make_sequence,
                                       render)

from slam_tpu_torch.geometry import se3


def drifted_odometry(poses_cw, drift, seed):
    """(N, 4, 4) odometry poses: a translation random walk of ``drift`` m
    per frame (rng seed ``seed + 7``) composed onto the ground truth, and
    (N, 4, 4) float32 deltas cam_t <- cam_{t-1} between them."""
    rng = np.random.default_rng(seed + 7)
    drift_rw = np.zeros(3)
    odo_cw = []
    for p in poses_cw:
        drift_rw += rng.normal(0.0, drift, 3)
        odo_cw.append(se3.se3_exp(
            np.concatenate([np.zeros(3), drift_rw])) @ p)
    odo_cw = np.stack(odo_cw)
    deltas = np.stack(
        [np.eye(4, dtype=np.float32)]
        + [(odo_cw[i] @ np.linalg.inv(odo_cw[i - 1])).astype(np.float32)
           for i in range(1, len(odo_cw))])
    return odo_cw, deltas


def ate(centers, gt_centers):
    err = centers - gt_centers
    err = err - err.mean(axis=0)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def run(n_frames=120, n_sequences=2, drift=0.0015, chunk=8, seed=0,
        progress=True, window=0, window_ba_every=4, tile=0, preset="frozen",
        lowe=None, slam=False, device="cuda"):
    """Returns a dict with the keys of ``tools/run_device_vo_euroc.run``.
    ``slam=True`` runs the whole device-SLAM serving path; ATE then uses the
    closure-corrected trajectory log."""
    import torch

    from slam_tpu_torch.pipeline.device_vo import (BatchedDeviceVO,
                                                   DeviceVOConfig)

    n_frames = (n_frames // chunk) * chunk

    # per-sequence scene + ground truth + drifted odometry
    seqs = []
    t0 = time.perf_counter()
    for s in range(n_sequences):
        scene = make_scene(seed + s, tile=tile)
        _, poses_cw = make_sequence(n_frames, seed + s)
        odo_cw, deltas = drifted_odometry(poses_cw, drift, seed + s)
        frames = np.stack([render(scene, poses_cw[i])
                           for i in range(n_frames)])
        seqs.append((poses_cw, odo_cw, frames, deltas))
        if progress:
            print(f"seq {s}: rendered {n_frames} frames", flush=True)
    render_s = time.perf_counter() - t0

    images = np.stack([s[2] for s in seqs])           # (S, N, H, W)
    deltas = np.stack([s[3] for s in seqs])           # (S, N, 4, 4)

    # presets: "frozen" = the bounded-episode preset (the map persists for
    # the whole episode and landmark depths stay at their creation anchor);
    # "default" = DeviceVOConfig defaults except the required shapes
    kw = dict(width=CAM.width, height=CAM.height,
              lm_capacity=512, max_keypoints=600,
              window=window, window_ba_every=window_ba_every)
    if preset == "frozen":
        kw.update(stale_age=n_frames, max_depth_step=0.0)
    elif preset != "default":
        raise ValueError(preset)
    if lowe is not None:
        kw.update(match_lowe_ratio=lowe)
    p0 = np.stack([s[0][0] for s in seqs]).astype(np.float32)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_closures = None
    if slam:
        from slam_tpu_torch.pipeline.device_slam import (DeviceSlam,
                                                         DeviceSlamParams)

        kw.update(loop_every=4, loop_slots=64, loop_words=512,
                  loop_min_gap=40, loop_points=192)
        cfg = DeviceVOConfig(**kw)
        params = DeviceSlamParams(frame_dt=1.0 / 20.0)

        def drive():
            s = DeviceSlam(cfg, batch=n_sequences, camera=CAM, params=params,
                           device=device)
            s.vo.reset(p0)
            for c in range(n_frames // chunk):
                slc = slice(c * chunk, (c + 1) * chunk)
                s.advance(images[:, slc], deltas[:, slc])
            s.finish()
            return s

        drive()                       # warm-up: allocator, kernel builds
        sync()
        t0 = time.perf_counter()
        sl_run = drive()
        sync()
        vo_s = time.perf_counter() - t0
        poses = np.stack([sl_run.trajectory(s) for s in range(n_sequences)])
        n_closures = sum(1 for e in sl_run.closures if e.accepted)
    else:
        cfg = DeviceVOConfig(**kw)
        vo = BatchedDeviceVO(cfg, batch=n_sequences, camera=CAM,
                             device=device)
        vo.reset(poses0_cw=p0)

        # warm-up chunk, then a timed fresh run over all chunks
        out = vo.advance(images[:, :chunk], deltas[:, :chunk])
        out.pose_cw.cpu()
        vo.reset(poses0_cw=p0)
        t0 = time.perf_counter()
        outs = []
        for c in range(n_frames // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            outs.append(vo.advance(images[:, sl], deltas[:, sl]))
        poses = np.concatenate([o.pose_cw.cpu().numpy() for o in outs],
                               axis=1)
        vo_s = time.perf_counter() - t0

    per_seq = []
    for s, (poses_cw, odo_cw, _, _) in enumerate(seqs):
        gt_c = np.stack([se3.camera_center(p) for p in poses_cw])
        vo_c = np.stack([se3.camera_center(p) for p in poses[s]])
        od_c = np.stack([se3.camera_center(p) for p in odo_cw])
        per_seq.append({"ate_vo_m": ate(vo_c, gt_c),
                        "ate_odometry_m": ate(od_c, gt_c)})

    return {
        "frames": n_frames, "sequences": n_sequences, "drift": drift,
        "slam": bool(slam), "closures_accepted": n_closures,
        "window": window, "tile": tile, "preset": preset,
        "lowe": lowe if lowe is not None else cfg.match_lowe_ratio,
        "per_sequence": per_seq,
        "ate_vo_m_mean": float(np.mean([x["ate_vo_m"] for x in per_seq])),
        "ate_odometry_m_mean": float(np.mean([x["ate_odometry_m"]
                                              for x in per_seq])),
        "vo_keyframes_per_sec": n_sequences * n_frames / vo_s,
        "render_s": render_s,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--sequences", type=int, default=2)
    ap.add_argument("--drift", type=float, default=0.0015)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window", type=int, default=8,
                    help="sliding-window size for the device-resident local"
                         " BA (0 = pose-only VO)")
    ap.add_argument("--window-ba-every", type=int, default=4)
    ap.add_argument("--tile", type=int, default=0,
                    help="repeating-texture world: motif tiled NxN per wall")
    ap.add_argument("--preset", choices=("frozen", "default"),
                    default="frozen")
    ap.add_argument("--lowe", type=float, default=None,
                    help="override match_lowe_ratio (1.0 = off)")
    ap.add_argument("--slam", action="store_true",
                    help="full device-SLAM path; ATE uses the "
                         "closure-corrected trajectory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(n_frames=args.frames, n_sequences=args.sequences,
              drift=args.drift, chunk=args.chunk, seed=args.seed,
              window=args.window, window_ba_every=args.window_ba_every,
              tile=args.tile, preset=args.preset, lowe=args.lowe,
              slam=args.slam, device=args.device)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
