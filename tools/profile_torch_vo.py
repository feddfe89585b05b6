#!/usr/bin/env python
"""Where the PyTorch port's main path spends its time on one CUDA card.

    python3 tools/profile_torch_vo.py [--chunk 1] [--reps 3]
                                      [--out build/profile_torch_vo.json]

Runs ``chip_smoke.py``'s main-path configuration (S=4, 640x480, the
device-SLAM bench's settings) and measures one 8-frame chunk, always the
same one (``--chunk``), each time in a session advanced to it. On the eager
twin (``BatchedDeviceVO._advance_eager``, every op issued from Python):

  1. its wall, unprofiled: host clock between two synchronises, ``--reps``
     times, each in a fresh session;
  2. a ``torch.profiler`` trace: device busy time (the union of the CUDA
     activities' intervals), their count, and the top device rows. The idle
     share is 1 - busy / the median unprofiled wall of step 1.

Then on the replayed CUDA graph (``advance``; one instance whose graph was
captured in a warm-up, reset and advanced to the chunk by replays before
each measurement): the chunk's unprofiled wall ``--reps`` times, with the
device time of each stage from the stamps the replay writes on the card's
clock (``BatchedDeviceVO.last_stamps``, the stages of
``device_vo.stamp_stages``; the replay keeps its overlap, where timing each
stage between synchronises would remove it), and one replay under
``torch.profiler`` with its device busy time, activity and kernel counts
and idle share against the replayed wall.

Prints a summary and writes everything to ``--out`` as JSON. Needs one card.
"""
import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke
from slam_tpu_torch.ops.stamp import durations
from slam_tpu_torch.pipeline.device_vo import (BatchedDeviceVO, DeviceVOConfig,
                                               stamp_stages)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="build/profile_torch_vo.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_vo: no CUDA device")
    _, smi = chip_smoke.phase_device()
    cam, worlds, images, deltas = chip_smoke.make_inputs()
    cfg = DeviceVOConfig(**chip_smoke.CFG)
    p0 = np.stack([w.poses_cw[0] for w in worlds]).astype(np.float32)
    C = chip_smoke.CHUNK

    def chunk(c):
        return images[:, c * C:(c + 1) * C], deltas[:, c * C:(c + 1) * C]

    def session():
        """A fresh session advanced to the measured chunk, eagerly."""
        vo = BatchedDeviceVO(cfg, batch=chip_smoke.S, camera=cam,
                             device="cuda")
        vo.reset(p0)
        for c in range(args.chunk):
            vo._advance_eager(*chunk(c))
        torch.cuda.synchronize()
        return vo

    def timed_chunk(advance):
        t0 = time.perf_counter()
        advance(*chunk(args.chunk))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def profiled(advance):
        with torch.profiler.profile(activities=acts) as prof:
            wall = timed_chunk(advance)
        return prof, chip_smoke.device_activity(prof), wall

    session()                                 # warm-up: CUDA init, build
    walls = [timed_chunk(session()._advance_eager) for _ in range(args.reps)]
    wall = statistics.median(walls)

    prof, act, profiled_wall = profiled(session()._advance_eager)
    rows = sorted(prof.key_averages(),
                  key=lambda r: r.self_device_time_total, reverse=True)
    top = [dict(name=r.key, self_device_ms=r.self_device_time_total / 1e3,
                calls=r.count) for r in rows[:12]]

    # the replayed graph: capture once, then reset and replay to the chunk
    graph = BatchedDeviceVO(cfg, batch=chip_smoke.S, camera=cam,
                            device="cuda")
    graph.reset(p0)
    for c in range(2):                       # the eager chunk, the capture
        graph.advance(*chunk(c))

    def replayed_to_chunk():
        graph.reset(p0)
        for c in range(args.chunk):
            graph.advance(*chunk(c))
        torch.cuda.synchronize()
        return graph.advance

    replay_walls, stage_runs = [], []
    for _ in range(args.reps):
        replay_walls.append(timed_chunk(replayed_to_chunk()))
        stage_runs.append(durations(graph.last_stamps.cpu().numpy(),
                                    stamp_stages(cfg, C)))
    replay_wall = statistics.median(replay_walls)
    stages = {k: statistics.median(r[k] for r in stage_runs)
              for k in stage_runs[0]}
    stamped = sum(stages.values())
    _, ract, rprofiled_wall = profiled(replayed_to_chunk())

    frames = chip_smoke.S * C
    result = dict(
        card=smi, torch=torch.__version__, chunk=args.chunk,
        sequences=chip_smoke.S, frames_per_sequence=C,
        wall_s=walls, wall_median_s=wall,
        keyframes_per_s=frames / wall,
        profiled_wall_s=profiled_wall,
        device_busy_ms=act["busy_ms"], device_span_ms=act["span_ms"],
        device_activities=act["activities"],
        device_kernels=act["kernels"],
        activities_per_frame=act["activities"] / C,
        idle_share=(1.0 - act["busy_ms"] / (1e3 * wall))
        if act["activities"] else None,
        top_device_rows=top,
        replay=dict(wall_s=replay_walls, wall_median_s=replay_wall,
                    keyframes_per_s=frames / replay_wall,
                    capture_s=graph._chunks[0].graphs.capture_seconds,
                    stage_device_s=stages, stamped_s=stamped,
                    profiled_wall_s=rprofiled_wall,
                    device_busy_ms=ract["busy_ms"],
                    device_span_ms=ract["span_ms"],
                    device_activities=ract["activities"],
                    device_kernels=ract["kernels"],
                    idle_share_of_span=(1.0 - ract["busy_ms"]
                                        / ract["span_ms"])
                    if ract["activities"] else None,
                    busy_share_of_wall=ract["busy_ms"] / (1e3 * replay_wall)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)

    print(f"chunk {args.chunk} ({chip_smoke.S} x {C} frames) on {smi}, "
          f"torch {torch.__version__}")
    print("unprofiled wall: " + ", ".join(f"{w:.4f}" for w in walls)
          + f" s; median {wall:.4f} s = {frames / wall:.2f} keyframes/s")
    if act["activities"]:
        print(f"profiled wall {profiled_wall:.4f} s; device busy "
              f"{act['busy_ms']:.3f} ms in {act['activities']} activities "
              f"({act['activities'] / C:.0f} per frame, {act['kernels']} "
              f"kernels); idle share against the unprofiled wall "
              f"{100 * result['idle_share']:.2f} %")
    else:
        print("the profiler recorded no device activity: idle share not "
              "measured")
    for r in top:
        print(f"  {r['self_device_ms']:9.3f} ms {r['calls']:6d} x {r['name']}")
    rep = result["replay"]
    print("replayed graph, unprofiled wall: "
          + ", ".join(f"{w:.4f}" for w in replay_walls)
          + f" s; median {replay_wall:.4f} s = {frames / replay_wall:.2f} "
          f"keyframes/s; capture {rep['capture_s'][0]:.3f} s")
    print(f"replayed graph, device time by stage from its stamps "
          f"(median of {args.reps}; {1e3 * stamped:.3f} ms stamped):")
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {k:10s} {1e3 * v:9.3f} ms = {100 * v / stamped:5.1f} %")
    if ract["activities"]:
        print(f"replayed graph, profiled wall {rprofiled_wall:.4f} s; device "
              f"busy {ract['busy_ms']:.3f} ms of a {ract['span_ms']:.3f} ms "
              f"device span in {ract['activities']} activities "
              f"({ract['kernels']} kernels): idle "
              f"{100 * rep['idle_share_of_span']:.2f} % of the span; busy "
              f"{100 * rep['busy_share_of_wall']:.2f} % of the unprofiled "
              f"replayed wall")
    else:
        print("the profiler recorded no device activity in the replay: "
              "idle share not measured")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
