"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from ``slam_tpu_torch/csrc`` and the
tensor-core rate probe ``tools/mma_peak.cu`` (one nvcc each, in parallel),
measures the card's 1-bit mma rate, checks the kernel bit for bit against
its plain PyTorch version on the card (at the main path's shape, the
vocabulary's and ragged edge shapes, one launch per call) and times it
beside its bound, drives the port's main path at the device-SLAM bench's
settings twice: ``slam_tpu_torch.pipeline.device_vo.BatchedDeviceVO`` over
64 frames of exact odometry, then ``slam_tpu_torch.DeviceSlam`` (loop
closure included) over 128 frames of biased odometry beside a control
session that applies no closure; it checks both against the synthetic
ground truth and compares the front-end on CPU and card. Then it drives the
interactive path, ``slam_tpu_torch.pipeline.slam_api.Slam``, at the
pipeline bench's parameters over a biased square loop of 128 frames: the
ORB extractor with its words at the 65,536-word vocabulary, local BA,
loop closure; it runs the session twice and checks that the second
repeats the first bit for bit, the closure, the map's consistency and the
final error against the odometry's, and the extractor's words on CPU and
card. Then: the BA's PCG branch on a global problem above the dense-Schur
limit against the CPU, and the card's segment sums bit-equal to the CPU's;
``DescriptorTracker`` over the interactive frames; ``bench.py``'s four
concurrent sessions through ``parallel/batch.map_sequences``;
``BatchedDeviceVO(mesh=)`` on a mesh that lists the card twice, under
``utils/profiling.device_trace``; and ``parallel/multichip``'s update step.
Last the rendered-sequence tools (``tools/torch_*.py``) as a user runs them:
the EuRoC-class room through ``DescriptorTracker`` and ``Mapper`` (a
closure, SLAM ATE below the odometry's, a consistent map), the device VO
on the room (ATE below the odometry's) and a cut KITTI-class drive (a
blackout, the map saved and reloaded as an atlas, relocation reaching the
RANSAC stage); it prints its own wall. Any failed check raises, so the
exit code is non-zero. Without a CUDA card it exits non-zero before
printing any result.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the kernels' JSON record.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# main-path settings: the device-SLAM bench's device configuration
WIDTH, HEIGHT = 640, 480
S, CHUNK, LAP, FRAMES = 4, 8, 32, 64
CFG = dict(width=WIDTH, height=HEIGHT, lm_capacity=512, max_keypoints=600,
           window=8, window_ba_every=4, loop_every=4, loop_slots=32,
           loop_words=512, loop_min_gap=16, loop_points=192,
           # a CPU run of the port on these worlds scored every non-revisit
           # candidate at most 0.957 and the revisits at 1.0
           loop_min_score=0.97)
CENTRE_ERR_MAX = 0.05       # metres, the JAX package's tracking-test bound
# DeviceSlam phase: the device-SLAM bench's settings (bench.py:366-371,
# :377-378, :402-404): sessions of 128 frames over laps of 64, a vertical
# odometry bias so that closures have drift to correct, the device's score
# gate at 0.9
SLAM_FRAMES, SLAM_LAP, SLAM_BIAS_M = 128, 64, 2e-3
SLAM_CFG = dict(CFG, loop_min_score=0.9)
# interactive phase: the pipeline bench's parameters (bench.py:127-137), the
# default 65,536-word vocabulary and loop-closure gates, one square loop
# (lap 64, 128 frames) with the DeviceSlam phase's vertical odometry bias.
# Seed 31: on these frames the JAX package's Mapper (CPU) accepts one
# closure and ends 0.209 m from the truth against the odometry's 0.254 m
# (seeds 30, 32, 33 closed too, but ended at 0.251, 0.455, 0.342 m)
IA_FRAMES, IA_LAP, IA_SEED = 128, 64, 31
IA_PARAMS = dict(keyframeDecisionMinIntervalSeconds=0.0,
                 minVisibleMapPointsInCurrentFrameBA=8, localBAProblemSize=16,
                 adjacentSpaceSize=10, maxKeypoints=600, pipelinedLocalBA=True,
                 useFrontendSlam=False)
# PCG phase: a global-BA problem above the dense-Schur limit (K x M > 2^20),
# about 8 observations a point; and the local BA's padding quanta
# (slam_tpu/pipeline/bundle_adjustment.py:236-242) for the segment sums
PCG_K, PCG_M, PCG_OBS = 160, 8192, 8
QUANTA_K, QUANTA_M, QUANTA_OBS = 16, 256, 4          # O = 1024
# tracker phase: the interactive phase's first frames
TRACKER_FRAMES = 32
# concurrent sessions: bench.py's bench_aggregate (render_world seeds
# 10-13, the pipeline bench's parameters), 4 sessions cut from 30 frames to
# 12: on the card four sessions together ran 0.95 frames/s, and 30 frames
# took the phase 136 s
SESSIONS, SESSION_FRAMES = 4, 12
# multi-device update step at the interactive path's width
MC_PAIRS, MC_PARAMS = 8, dict(max_keypoints=600, hypotheses=128,
                              ba_capacity=256, ba_iterations=3)
BUILD_DIR = Path(__file__).resolve().parent / "build"
TRACE_DIR = BUILD_DIR / "chip_smoke_trace"
# the rendered-sequence tools (tools/torch_*.py), driven as a user runs them
TOOLS_DIR = Path(__file__).resolve().parent / "tools"
# EuRoC-class room (BASELINE configs 3/4): the setting at which the JAX
# package's tool closed its loop on both CPU and TPU (RESULTS.md:25-26)
EUROC_FRAMES, EUROC_DRIFT = 240, 0.004
# device VO on the room: the middle drift row of RESULTS.md:107-109
DVO_FRAMES, DVO_SEQS, DVO_DRIFT, DVO_WINDOW = 120, 2, 0.008, 8
# KITTI-class street (BASELINE config 5) cut to the small-circuit diagnostic
# (RESULTS.md:91-92: radius 30 m, heading bias 1.2e-4 rad/frame) and to a
# drive of 8 frames, the last 4 blacked out: one track reset, a saved map
# and a relocation pass whose atlas candidates reach the RANSAC stage. On
# the CPU 4 frames reached only BOW_MATCH, 6 frames sent 1 candidate to the
# RANSAC stage and 8 frames 3
KITTI_FRAMES, KITTI_RADIUS, KITTI_DRIFT_YAW = 8, 30.0, 1.2e-4
KITTI_MAP = BUILD_DIR / "chip_smoke_kitti.npz"


def cuda_time_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    from slam_tpu_torch.precision import pin_full_f32

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}")
    print(smi)
    pin_full_f32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def _near_copies(rng, base, n, flips):
    rows = base[rng.integers(0, len(base), n)].copy()
    bits = rng.integers(0, 256, (n, flips))
    for row, bb in zip(rows, bits):
        for b in bb:
            row[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return rows


# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W); the
# sheet gives no rate for the 1-bit mma that K1 issues, so mma_peaks()
# measures it
INT8_OPS_PER_S = 1979e12
BYTES_PER_S = 3.35e12
PEAK_SOURCE = Path(__file__).resolve().parent / "tools" / "mma_peak.cu"


def build_kernels():
    """One nvcc for each CUDA source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from slam_tpu_torch.kernels.build import load_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(load_library, ["hamming_argmin.cu", str(PEAK_SOURCE)]))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")


def mma_peaks(smi):
    """{form: operations per second} of the b1 (and.popc m16n8k256) and s8
    (m16n8k32) mma.sync forms, from a register-only loop on every SM
    (``tools/mma_peak.cu``): the best of five launches of 8 warps x 8
    chains x ``iters`` instructions a block, 4 blocks an SM (one wave)."""
    import ctypes

    from slam_tpu_torch.kernels.build import load_library

    fn = load_library(str(PEAK_SOURCE)).mma_peak_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    peaks = {}
    for form, name, ops_per_mma, iters in ((0, "b1", 2 * 16 * 8 * 256, 4096),
                                           (1, "s8", 2 * 16 * 8 * 32, 16384)):
        def run():
            err = fn(form, blocks, iters, out.data_ptr(), stream)
            assert err == 0, f"mma_peak launch failed: cudaError {err}"
        ms = min(cuda_time_ms(run, reps=1, warmup=1 if r == 0 else 0)
                 for r in range(5))
        peaks[name] = blocks * 8 * 8 * iters * ops_per_mma / (ms * 1e-3)
    print(f"mma.sync peak, register-only loop: b1 and.popc "
          f"{peaks['b1'] / 1e12:.1f} TOP/s, s8 {peaks['s8'] / 1e12:.1f} TOP/s "
          f"(published int8 peak {INT8_OPS_PER_S / 1e12:.0f} TOP/s); on {smi}")
    return peaks


def k1_bound(n, v, ops_per_s):
    """(bound ms, what sets it) of K1 on (n, 8) x (v, 8): 2 * n * v * 256
    bit operations at ``ops_per_s``, against reading both inputs once and
    writing dist and idx once."""
    ops_ms = 2 * n * v * 256 / ops_per_s * 1e3
    bytes_ms = (n * 32 + v * 32 + n * 8) / BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def _kernels_per_call(calls):
    """Names of the CUDA kernels the device ran during each of ``calls``, in
    one torch.profiler session: a one-element add runs on the device before
    the first call and after every call, and the device kernels between two
    adds belong to the call between them."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        for fn in calls:
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            marker.add_(1)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    is_marker = [("add" in e.name and "hamming" not in e.name)
                 for e in events]
    assert sum(is_marker) == len(calls) + 1 and is_marker[0] \
        and is_marker[-1], [e.name for e in events]
    per_call, current = [], []
    for e, m in zip(events[1:], is_marker[1:]):
        if m:
            per_call.append(current)
            current = []
        else:
            current.append(e.name)
    return per_call


def phase_kernel(smi, peaks):
    """K1 against its plain version, bit-equal, one launch per call, timed
    with its bound at every shape: the main path's and the vocabulary's and
    ragged edge shapes. Every codebook row 64k repeats row 64k - 1, so the
    first index must win across every cluster rank's first row (ranks
    split V into whole tiles of 64 rows)."""
    from slam_tpu_torch.ops.bow import make_codebook
    from slam_tpu_torch.ops.hamming_argmin import (hamming_argmin,
                                                   hamming_argmin_plain)
    from slam_tpu_torch.pipeline.device_vo import _loop_codebook

    ops_per_s = max(INT8_OPS_PER_S, peaks["b1"])
    peak_by = "measured b1" if peaks["b1"] > INT8_OPS_PER_S else "int8"
    rng = np.random.default_rng(0)
    vocab = make_codebook(65536)
    rand = lambda v: rng.integers(0, 2 ** 32, (v, 8), dtype=np.uint32)
    shapes = [("main path", S * 608, _loop_codebook(512)),
              ("vocabulary", 4096, vocab),
              ("interactive", 256 + IA_PARAMS["maxKeypoints"], vocab),
              # DescriptorTracker's extractor keeps 128 tracked slots
              ("tracker", 128 + IA_PARAMS["maxKeypoints"], vocab),
              # the rendered-sequence tools at the default 1,000 keypoints:
              # the tracker's extractor and the Mapper's (256 tracked slots)
              ("tools tracker", 128 + 1000, vocab),
              ("tools mapper", 256 + 1000, vocab),
              ("N=1", 1, _loop_codebook(512)),
              ("N=2433", 2433, _loop_codebook(512)),
              ("V=1", 300, rand(1)),
              ("V=513", 2432, rand(513)),
              ("V=65535", 2432, vocab[:65535])]
    results, max_err, calls = {}, 0, []
    for label, n, cb in shapes:
        cb = cb.copy()
        v = len(cb)
        cb[64::64] = cb[63:-1:64]             # row 64k repeats row 64k - 1
        tied = list(range(63, v - 1, 64))
        desc = _near_copies(rng, cb, n, flips=24)
        desc[:len(tied)] = cb[tied][:n]       # exact hits on the tied rows
        first = [np.flatnonzero((cb == cb[j]).all(1))[0] for j in tied]
        d = torch.from_numpy(desc.view(np.int32)).cuda()
        c = torch.from_numpy(np.ascontiguousarray(cb).view(np.int32)).cuda()
        before = hamming_argmin.launches
        kd, ki = hamming_argmin(d, c)
        assert hamming_argmin.launches == before + 1
        pd, pi = hamming_argmin_plain(d, c)
        torch.cuda.synchronize()
        err = max(int((kd - pd).abs().max()), int((ki - pi).abs().max()))
        max_err = max(max_err, err)
        assert torch.equal(kd, pd) and torch.equal(ki, pi), (label, err)
        hits = ki[:len(tied)].cpu().numpy()
        assert (hits == np.array(first[:n])).all(), (label, hits, first)
        calls.append(lambda d=d, c=c: hamming_argmin(d, c))
        ms = cuda_time_ms(lambda: hamming_argmin(d, c))
        plain_ms = cuda_time_ms(lambda: hamming_argmin_plain(d, c))
        bound_ms, bound_by = k1_bound(n, v, ops_per_s)
        results[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
        int8_ms, _ = k1_bound(n, v, INT8_OPS_PER_S)
        print(f"hamming_argmin {label} ({n}, 8) x ({v}, 8): bit-equal, "
              f"first index wins at {len(tied)} tied 64-row boundaries; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.3g} ms ({bound_by}, {peak_by} peak), kernel at "
              f"{bound_ms / ms:.1%} of the bound ({int8_ms / ms:.1%} of the "
              f"int8-peak bound {int8_ms:.3g} ms); on {smi}")
    # one device kernel per call: no fill, merge or unpack launch
    per_call = _kernels_per_call(calls)
    for (label, _, _), names in zip(shapes, per_call):
        assert len(names) == 1 and "hamming_argmin" in names[0], (label,
                                                                  names)
    print(f"hamming_argmin: each of {len(calls)} calls ran one device kernel "
          f"({per_call[0][0]})")

    # yardstick for the product alone, never called by the port: a bf16
    # matmul of the +-1 expansions
    from slam_tpu_torch.ops.hamming import unpack_bits_pm1
    line = []
    for label, n, cb in shapes:
        if n * len(cb) < 2 ** 20:             # the tiny edge shapes
            continue
        a = unpack_bits_pm1(torch.from_numpy(
            _near_copies(rng, cb, n, 24).view(np.int32)).cuda()).bfloat16()
        b = unpack_bits_pm1(torch.from_numpy(
            np.ascontiguousarray(cb).view(np.int32)).cuda()).bfloat16().T
        mm_ms = cuda_time_ms(lambda: torch.matmul(a, b))
        line.append(f"{label} ({n}, 256) x (256, {len(cb)}) {mm_ms:.4f} ms")
        results[label]["matmul_ms"] = mm_ms
    print("yardstick torch.matmul of the +-1 bf16 expansions: "
          + "; ".join(line) + f"; on {smi}")
    results["max_abs_err"] = max_err
    return results


def make_inputs():
    from slam_tpu_torch.utils.synthetic import (default_camera, exact_odometry,
                                                make_world, render_frame)

    cam = default_camera(WIDTH, HEIGHT)
    worlds = [make_world(n_frames=FRAMES, n_landmarks=500, seed=30 + s,
                         trajectory="loop", lap_frames=LAP, camera=cam)
              for s in range(S)]
    rng = np.random.default_rng(31)
    patch_sets = [rng.integers(40, 255, (500, 11, 11)).astype(np.uint8)
                  for _ in range(S)]
    images = np.stack([np.stack([render_frame(w, p, i, WIDTH, HEIGHT)
                                 for i in range(FRAMES)])
                       for w, p in zip(worlds, patch_sets)])
    deltas = np.stack([exact_odometry(w, FRAMES) for w in worlds])
    return cam, worlds, images, deltas


def phase_main_path(cam, worlds, images, deltas):
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin
    from slam_tpu_torch.pipeline.device_vo import (BatchedDeviceVO,
                                                   DeviceVOConfig)

    cfg = DeviceVOConfig(**CFG)
    p0 = np.stack([w.poses_cw[0] for w in worlds]).astype(np.float32)

    def fresh():
        vo = BatchedDeviceVO(cfg, batch=S, camera=cam, device="cuda")
        vo.reset(p0)
        return vo

    def run(vo, n_chunks):
        return [vo.advance(images[:, c * CHUNK:(c + 1) * CHUNK],
                           deltas[:, c * CHUNK:(c + 1) * CHUNK])
                for c in range(n_chunks)]

    run(fresh(), 1)                           # warm-up: CUDA init, caches
    vo = fresh()                              # set-up stays out of the wall
    torch.cuda.synchronize()
    hamming_argmin.launches = 0
    t0 = time.perf_counter()
    outs = run(vo, FRAMES // CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hamming_argmin.launches

    cat = lambda k: np.concatenate([getattr(o, k).cpu().numpy() for o in outs],
                                   axis=1)
    poses, n_matched = cat("pose_cw"), cat("n_matched")
    loop_frame, loop_score = cat("loop_frame"), cat("loop_score")
    np.set_printoptions(linewidth=200)
    print("n_matched per frame:\n", n_matched)
    print("loop_frame per frame:\n", loop_frame)
    assert poses.shape == (S, FRAMES, 4, 4) and np.isfinite(poses).all()

    centres = -np.einsum("stji,stj->sti", poses[..., :3, :3],
                         poses[..., :3, 3])
    truth = np.stack([[-w.poses_cw[i][:3, :3].T @ w.poses_cw[i][:3, 3]
                       for i in range(FRAMES)] for w in worlds])
    err = np.linalg.norm(centres - truth, axis=-1)
    print(f"camera-centre error: max {err.max():.6f} m, "
          f"mean {err.mean():.6f} m")
    assert err.max() < CENTRE_ERR_MAX, err.max(axis=1)

    # matching engages from frame 3. The square loop turns 90 degrees
    # between two frames at each corner (every LAP // 4 frames), where no
    # map point stays in view; the first side is free of corners.
    assert n_matched[:, 3:LAP // 4].min() >= 20, n_matched[:, :LAP // 4]
    assert n_matched[:, 3:].mean() >= 20, n_matched[:, 3:].mean()

    # the first lap stays silent; every flag on the second lap names the
    # same place one lap earlier (within 2 frames), and every sequence
    # flags its revisit
    assert (loop_frame[:, :LAP] == -1).all(), loop_frame[:, :LAP]
    frames = np.arange(FRAMES)
    flagged = loop_frame >= 0
    assert (np.abs(loop_frame - (frames - LAP))[flagged] <= 2).all()
    assert flagged[:, LAP:].any(axis=1).all(), loop_frame
    top = loop_score[:, LAP:][~flagged[:, LAP:]]
    print(f"revisits flagged: {int(flagged.sum())} frames; best unflagged "
          f"second-lap score {top.max():.4f} (gate {cfg.loop_min_score})")

    # K1 ran once per frame for all S sequences
    assert launches == FRAMES, launches
    fps = S * FRAMES / wall
    return dict(wall=wall, fps=fps, launches=launches)


def make_slam_inputs(cam):
    """The device-SLAM bench's worlds (bench.py:380-402): square loops with
    a lap of SLAM_LAP frames, seeds 30-33, and a constant vertical odometry
    bias of SLAM_BIAS_M m per frame."""
    from slam_tpu_torch.utils.synthetic import (exact_odometry, make_world,
                                                render_frame)

    worlds = [make_world(n_frames=SLAM_FRAMES, n_landmarks=500, seed=30 + s,
                         trajectory="loop", lap_frames=SLAM_LAP, camera=cam)
              for s in range(S)]
    rng = np.random.default_rng(31)
    patch_sets = [rng.integers(40, 255, (500, 11, 11)).astype(np.uint8)
                  for _ in range(S)]
    images = np.stack([np.stack([render_frame(w, p, i, WIDTH, HEIGHT)
                                 for i in range(SLAM_FRAMES)])
                       for w, p in zip(worlds, patch_sets)])
    deltas = np.stack([exact_odometry(w, SLAM_FRAMES) for w in worlds])
    bias = np.eye(4, dtype=np.float32)
    bias[1, 3] = SLAM_BIAS_M
    deltas[:, 1:] = np.einsum("ij,stjk->stik", bias, deltas[:, 1:])
    return worlds, images, deltas


def phase_device_slam(cam, worlds, images, deltas, smi):
    """``DeviceSlam`` sessions at the device-SLAM bench's settings: one
    warm-up, one timed, one control with closures not applied. Checks the
    closures and the trajectory against ground truth and the control, and
    times the host consumer and the rebase."""
    from slam_tpu_torch import DeviceSlam, DeviceSlamParams
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin
    from slam_tpu_torch.pipeline.device_vo import (BatchedDeviceVO,
                                                   DeviceVOConfig,
                                                   _rebase_states)

    cfg = DeviceVOConfig(**SLAM_CFG)
    params = DeviceSlamParams(frame_dt=0.1, min_closure_gap_s=2.0,
                              calib_frames=20)
    p0 = np.stack([w.poses_cw[0] for w in worlds]).astype(np.float32)

    def session(apply_closures):
        slam = DeviceSlam(cfg, batch=S, camera=cam,
                          params=params._replace(
                              apply_closures=apply_closures))
        slam.vo.reset(p0)
        times = {"consume": [], "try_close": []}
        for name in times:                   # host clock around each call
            def timed(*args, _fn=getattr(slam, "_" + name), _log=times[name]):
                t0 = time.perf_counter()
                out = _fn(*args)
                _log.append(time.perf_counter() - t0)
                return out
            setattr(slam, "_" + name, timed)
        torch.cuda.synchronize()
        hamming_argmin.launches = 0
        t0 = time.perf_counter()
        for c in range(SLAM_FRAMES // CHUNK):
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            slam.advance(images[:, sl], deltas[:, sl])
        slam.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return slam, wall, hamming_argmin.launches, times

    session(True)                             # warm-up: CUDA init, caches
    slam, wall, launches, times = session(True)
    control, control_wall, control_launches, _ = session(False)
    # the same frames through the VO backend alone, for the closure loop's
    # share of the wall
    vo = BatchedDeviceVO(cfg, batch=S, camera=cam)
    vo.reset(p0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(SLAM_FRAMES // CHUNK):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        vo.advance(images[:, sl], deltas[:, sl])
    torch.cuda.synchronize()
    vo_wall = time.perf_counter() - t0

    # K1 ran once per frame for all S sequences, in both sessions
    assert launches == control_launches == SLAM_FRAMES, (launches,
                                                         control_launches)
    accepted = [e for e in slam.closures if e.accepted]
    reasons = {}
    for e in slam.closures:
        reasons[e.reason] = reasons.get(e.reason, 0) + 1
    print(f"device_slam closures: {len(accepted)} accepted, by reason "
          f"{reasons}: "
          + ", ".join(f"s{e.seq} ({e.query_frame}, {e.cand_frame}) "
                      f"{e.n_matches}/{e.n_inliers}" for e in accepted)
          + f"; on {smi}")
    for s in range(S):
        assert any(e.seq == s for e in accepted), (s, reasons)
    for e in accepted:
        gap = e.query_frame - e.cand_frame
        laps = round(gap / SLAM_LAP)
        assert laps >= 1 and abs(gap - laps * SLAM_LAP) <= cfg.loop_every, e
    lags = slam.closure_lags
    assert lags and all(0 < lag <= 3 * CHUNK for lag in lags), lags

    # after each sequence's first accepted query the corrected trajectory
    # tracks ground truth better than the control's
    errs = []
    for s in range(S):
        q = min(e.query_frame for e in accepted if e.seq == s)
        w = worlds[s]
        truth = np.stack([-w.poses_cw[i][:3, :3].T @ w.poses_cw[i][:3, 3]
                          for i in range(q, SLAM_FRAMES)])

        def err(run):
            traj = run.trajectory(s)[q:]
            centres = -np.einsum("tji,tj->ti", traj[:, :3, :3],
                                 traj[:, :3, 3])
            return float(np.linalg.norm(centres - truth, axis=-1).mean())
        errs.append((err(slam), err(control)))
    print("device_slam camera-centre error after the first closure, "
          "closed vs control (m): "
          + ", ".join(f"s{s} {a:.6f} vs {b:.6f}" for s, (a, b)
                      in enumerate(errs)) + f"; on {smi}")
    assert all(a < b for a, b in errs), errs

    n_chunks = SLAM_FRAMES // CHUNK
    consume_ms = 1e3 * np.array(times["consume"])
    try_ms = 1e3 * np.array(times["try_close"])
    fps = S * SLAM_FRAMES / wall
    print(f"device_slam: {S} sequences x {SLAM_FRAMES} frames at "
          f"{WIDTH}x{HEIGHT} in {wall:.3f} s = {fps:.2f} keyframes/s "
          f"(control without rebases {S * SLAM_FRAMES / control_wall:.2f}, "
          f"BatchedDeviceVO alone {S * SLAM_FRAMES / vo_wall:.2f}); "
          f"on {smi}")
    print(f"device_slam host consumer: {consume_ms.sum() / n_chunks:.3f} ms "
          f"per chunk over {len(consume_ms)} calls (max "
          f"{consume_ms.max():.3f} ms), {consume_ms.sum() / 1e3 / wall:.2%} "
          f"of the session wall; {len(try_ms)} closure attempts at "
          f"{try_ms.mean():.3f} ms each; mean closure lag "
          f"{np.mean(lags):.2f} frames ({len(lags)} closures); on {smi}")

    # the rebase dispatch on the session's final state, every sequence
    # closing with its last accepted correction, merge on
    dev = slam.vo.device
    Ts = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    cands = np.zeros(S, np.int32)
    for e in accepted:
        Ts[e.seq], cands[e.seq] = e.T, e.cand_frame
    args = (slam.vo.state, torch.from_numpy(Ts).to(dev),
            torch.ones(S, dtype=torch.bool, device=dev),
            torch.from_numpy(cands).to(dev),
            torch.from_numpy((cands // cfg.loop_every) % cfg.loop_slots
                             ).to(dev))
    kw = dict(merge_radius=params.merge_radius_m, merge=True)
    out = _rebase_states(*args, **kw)
    # the same dispatch on the CPU: integer fields equal, floats within 1e-4
    ref = _rebase_states(type(args[0])(*(t.cpu() for t in args[0])),
                         *(t.cpu() for t in args[1:]), **kw)
    float_err = 0.0
    for name, a, b in zip(out._fields, out, ref):
        if a.is_floating_point():
            assert bool(torch.isfinite(a).all()), name
            float_err = max(float_err, float((a.cpu() - b).abs().max()))
        else:
            assert torch.equal(a.cpu(), b), name
    assert float_err < 1e-4, float_err
    merged = int((slam.vo.state.lm_valid & ~out.lm_valid).sum())
    rebase_ms = cuda_time_ms(lambda: _rebase_states(*args, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        _rebase_states(*args, **kw)
    enqueue_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    print(f"device_slam rebase dispatch (S={S}, merge on): {rebase_ms:.3f} "
          f"ms between CUDA events, {enqueue_ms:.3f} ms of host enqueue; "
          f"{merged} duplicates merged, equal to the CPU's (floats within "
          f"{float_err:.2e}); on {smi}")
    return dict(wall=wall, fps=fps, launches=launches, accepted=len(accepted),
                consume_ms_per_chunk=consume_ms.sum() / n_chunks,
                rebase_ms=rebase_ms)


def make_interactive_inputs(cam):
    """Frames and biased odometry poses of the interactive phase's world."""
    from slam_tpu_torch.utils.synthetic import make_world, render_frame

    world = make_world(n_frames=IA_FRAMES, n_landmarks=500, seed=IA_SEED,
                       trajectory="loop", lap_frames=IA_LAP, camera=cam)
    patches = np.random.default_rng(31).integers(
        40, 255, (500, 11, 11)).astype(np.uint8)
    frames = [render_frame(world, patches, i, WIDTH, HEIGHT)
              for i in range(IA_FRAMES)]
    odom = []
    for i, T in enumerate(world.poses_cw):
        T = T.copy()                  # camera centre raised by i * bias
        T[:3, 3] -= T[:3, :3] @ np.array([0.0, i * SLAM_BIAS_M, 0.0])
        odom.append(T)
    return world, frames, odom


def phase_interactive(cam, world, frames, odom, smi):
    """``Slam.build`` -> ``add_frame`` -> ``end`` on the card: the session
    once as a warm-up, then again, timed. Checks that the timed session
    repeats the warm-up bit for bit (the BA's segment sums add in a fixed
    order), the closure, consistency, the final keyframe's error against
    the odometry's, K1's launches against the extractions and device
    quantizations, and frame 0's words on CPU and card."""
    from slam_tpu_torch import native
    from slam_tpu_torch.map.keyframe import MapperInput, Pose
    from slam_tpu_torch.ops import bow
    from slam_tpu_torch.ops.frontend import OrbExtractor
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin
    from slam_tpu_torch.params import Parameters, ParametersSlam
    from slam_tpu_torch.pipeline.mapper_helpers import check_consistency
    from slam_tpu_torch.pipeline.slam_api import Slam
    from slam_tpu_torch.utils import timer

    assert native.available(), "the native host library did not build"
    params = Parameters(slam=ParametersSlam(**IA_PARAMS))

    def mapper_input(i):
        return MapperInput(
            frame=frames[i], camera=cam, track_ids=np.zeros(0, np.int64),
            track_pts=np.zeros((0, 2), np.float32), track_depths=None,
            pose_trail=[Pose(frame_number=j, t=world.times[j],
                             pose_cw=odom[j].copy())
                        for j in range(i, max(-1, i - 6), -1)],
            t=world.times[i])

    def session():
        slam = Slam.build(params, device="cuda")
        inputs = [mapper_input(i) for i in range(IA_FRAMES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, mi in enumerate(inputs):
            if i + 1 < IA_FRAMES:  # the next frame's extraction overlaps
                slam.mapper.prefetch(inputs[i + 1])
            fut = slam.add_frame(frame=mi.frame, pose_trail=mi.pose_trail,
                                 features_ids=mi.track_ids,
                                 features_pts=mi.track_pts, camera=cam)
            assert fut.result().pose_mat.shape == (4, 4)
        assert slam.end().result()
        torch.cuda.synchronize()
        return slam, time.perf_counter() - t0

    def outcome(slam):
        db = slam.mapper.map_db
        return ([(int(e.kf_id1), int(e.kf_id2))
                 for e in db.loop_closure_edges],
                sorted(int(k) for k in db.map_points),
                {int(k): kf.pose_cw for k, kf in db.keyframes.items()})

    warm, _ = session()                       # warm-up: caches, allocator
    stats = timer.enable_timing()
    hamming_argmin.launches = 0
    bow.quantize.device_calls = 0
    slam, wall = session()
    launches = hamming_argmin.launches
    quantized = bow.quantize.device_calls
    timer.disable_timing()
    (edges0, mps0, poses0), (edges, mps, poses) = outcome(warm), outcome(slam)
    assert edges == edges0 and mps == mps0 and poses.keys() == poses0.keys(), \
        ("the session did not repeat", edges0, edges)
    assert all(np.array_equal(poses[k], poses0[k]) for k in poses), \
        "the session's poses did not repeat bit for bit"
    mapper = slam.mapper
    db = mapper.map_db
    check_consistency(db)
    extractions = mapper._orb_extractor.extractions
    assert launches == extractions + quantized > 0, (launches, extractions,
                                                     quantized)
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]
    final = db.latest_keyframe()
    k = int(final.id)
    err = float(np.linalg.norm(centre(final.pose_cw)
                               - centre(world.poses_cw[k])))
    odom_err = float(np.linalg.norm(centre(odom[k])
                                    - centre(world.poses_cw[k])))
    fps = IA_FRAMES / wall
    print(f"interactive Slam: {IA_FRAMES} frames at {WIDTH}x{HEIGHT} in "
          f"{wall:.3f} s = {fps:.2f} frames/s, the warm-up repeated bit for "
          f"bit; {len(db.keyframes)} keyframes, "
          f"{len(db.map_points)} map points, closures {edges} (loop stats "
          f"{dict(mapper.loop_closer.stats.totals)}); final keyframe {k} "
          f"camera-centre error {err:.6f} m vs odometry {odom_err:.6f} m; "
          f"K1 launches {launches} = {extractions} extractions + {quantized} "
          f"device quantizations; on {smi}")
    print(f"interactive host sections (host clock, timed session), on {smi}:"
          f"\n{stats.table()}")
    assert edges, "no loop closure accepted"
    assert err < odom_err, (err, odom_err)

    # frame 0 through the extractor on CPU and on the card
    settings = mapper.settings
    res = {dev: OrbExtractor(settings, WIDTH, HEIGHT, device=dev)
           .detect_and_extract(frames[0]) for dev in ("cpu", "cuda")}
    same = (res["cpu"].descriptors == res["cuda"].descriptors).all(axis=1)
    assert same.mean() > 0.9, same.mean()
    assert (res["cpu"].words[same] == res["cuda"].words[same]).all()
    print(f"OrbExtractor CPU vs card, frame 0: {same.mean():.4%} of slots "
          f"with equal descriptors, their words all equal")
    return dict(wall=wall, fps=fps, launches=launches, edges=edges, err=err,
                odom_err=odom_err)


def phase_ba_card(smi):
    """PCG on the card: a global-BA problem above the dense-Schur limit,
    solved on the card and on the CPU (poses and points within 1e-4); then
    the normal blocks' segment sums of a padded local-BA problem at the
    reference's quanta, bit-equal on the card and the CPU."""
    from slam_tpu_torch.ops import ba
    from slam_tpu_torch.utils.synthetic import ba_problem

    assert PCG_K * PCG_M > ba.DENSE_SCHUR_MAX_KM
    cg = ba.pick_cg_iters(PCG_K, PCG_M)
    assert cg == 96, cg
    p = ba_problem(PCG_K, PCG_M, PCG_OBS, seed=0)
    on = lambda q, dev: type(q)(*(t.to(dev) for t in q))
    t0 = time.perf_counter()
    cpu = ba.solve_ba(p, 5, cg)
    cpu_s = time.perf_counter() - t0
    pc = on(p, "cuda")
    ba.solve_ba(pc, 5, cg)                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = ba.solve_ba(pc, 5, cg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cost0 = float(ba._total_cost(p.poses, p.points, p, ba.HUBER_DELTA)[0])
    pose_err = float((card.poses.cpu() - cpu.poses).abs().max())
    point_err = float((card.points.cpu() - cpu.points).abs().max())
    # the f32 floor of this problem: the CPU's f32 solve against its f64 one
    f64 = ba.solve_ba(type(p)(*(t.double() if t.is_floating_point() else t
                                for t in p)), 5, cg)
    floor = float((cpu.points.double() - f64.points).abs().max())
    print(f"PCG global BA K={PCG_K} M={PCG_M} O={PCG_M * PCG_OBS} (K x M = "
          f"{PCG_K * PCG_M} > {ba.DENSE_SCHUR_MAX_KM}), 5 LM iterations x "
          f"{cg} PCG steps: cost {cost0:.1f} -> card {float(card.cost):.1f}, "
          f"CPU {float(cpu.cost):.1f}; card vs CPU poses {pose_err:.2e}, "
          f"points {point_err:.2e} (CPU f32 vs f64 points {floor:.2e}); "
          f"card {card_s * 1e3:.1f} ms, CPU "
          f"{cpu_s * 1e3:.1f} ms; on {smi}")
    assert bool(torch.isfinite(card.poses).all()), "PCG diverged on the card"
    assert float(card.cost) < 0.5 * cost0, (float(card.cost), cost0)
    assert pose_err < 1e-4 and point_err < 1e-4, (pose_err, point_err)

    # the normal blocks each LM step sums, from the same inputs
    q = ba_problem(QUANTA_K, QUANTA_M, QUANTA_OBS, seed=1)
    r, J_pose, J_pt, _, _ = ba._reproj_terms(q.poses, q.points, q,
                                             ba.HUBER_DELTA)
    M = QUANTA_M
    blocks = {
        "Hpp 6x6": (torch.einsum("soci,socj->soij", J_pose, J_pose),
                    q.obs_kf, QUANTA_K),
        "Wkm 6x3": (torch.einsum("soci,socj->soij", J_pose, J_pt),
                    q.obs_kf * M + q.obs_mp, QUANTA_K * M),
        "Hll 3x3": (torch.einsum("soci,socj->soij", J_pt, J_pt), q.obs_mp, M),
        "bp 6": (-torch.einsum("soci,soc->soi", J_pose, r), q.obs_kf,
                 QUANTA_K),
        "bl 3": (-torch.einsum("soci,soc->soi", J_pt, r), q.obs_mp, M)}
    for name, (v, idx, n) in blocks.items():
        want = ba.segment_sum(v, idx, n)
        got = ba.segment_sum(v.cuda(), idx.cuda(), n).cpu()
        assert torch.equal(got, want), (name, float((got - want).abs().max()))
    print(f"segment_sum card vs CPU at K={QUANTA_K} M={QUANTA_M} "
          f"O={QUANTA_M * QUANTA_OBS}: bit-equal for "
          + ", ".join(blocks))
    return dict(pcg_card_ms=card_s * 1e3, pcg_cpu_ms=cpu_s * 1e3,
                pose_err=pose_err, point_err=point_err)


def phase_tracker(frames, smi):
    """``DescriptorTracker(device="cuda")`` over the interactive phase's
    first frames: tracks persist, ids are unique and fresh ids monotonic,
    and K1 ran once per extraction."""
    from slam_tpu_torch.frontends.descriptor_tracker import DescriptorTracker
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin
    from slam_tpu_torch.params import Parameters, ParametersSlam, \
        StaticSettings

    settings = StaticSettings(Parameters(slam=ParametersSlam(**IA_PARAMS)))
    warm = DescriptorTracker(settings, WIDTH, HEIGHT, device="cuda")
    for f in frames[:2]:
        warm.process(f)
    tracker = DescriptorTracker(settings, WIDTH, HEIGHT, device="cuda")
    torch.cuda.synchronize()
    hamming_argmin.launches = 0
    t0 = time.perf_counter()
    out = [tracker.process(f) for f in frames[:TRACKER_FRAMES]]
    wall = time.perf_counter() - t0
    launches = hamming_argmin.launches
    seen, carried = set(), []
    for prev, cur in zip(out, out[1:]):
        carried.append(len(set(prev.tracked_id_list.tolist())
                           & set(cur.tracked_id_list.tolist())))
    for tf in out:
        ids = tf.tracked_id_list.tolist()
        assert len(ids) == len(set(ids)), "track ids repeat within a frame"
        seen.update(ids)
    assert len(out[0].tracked_id_list) > 30, len(out[0].tracked_id_list)
    # the square loop turns at every LAP // 4 frames; tracks carry along
    # the first side
    side = IA_LAP // 4
    assert min(carried[:side - 1]) > 15, carried
    assert tracker._next_id == max(seen) + 1
    extractions = tracker.extractor.extractions
    assert launches == extractions == TRACKER_FRAMES, (launches, extractions)
    print(f"DescriptorTracker: {TRACKER_FRAMES} frames at {WIDTH}x{HEIGHT} "
          f"in {wall:.3f} s = {wall / TRACKER_FRAMES * 1e3:.2f} ms a frame; "
          f"{len(out[0].tracked_id_list)} tracks on frame 0, carried "
          f"{min(carried[:side - 1])}-{max(carried)} a frame, {len(seen)} "
          f"ids; K1 launches {launches} = {extractions} extractions; "
          f"on {smi}")
    return dict(launches=launches, ms_per_frame=wall / TRACKER_FRAMES * 1e3)


def make_session_inputs():
    """bench.py's bench_aggregate sequences: render_world(seed=10 + s)
    over SESSION_FRAMES frames, frames through render_frame, odometry pose
    trails."""
    from slam_tpu_torch.map.keyframe import MapperInput, Pose
    from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                                render_frame)

    seqs = []
    for s in range(SESSIONS):
        world = make_world(n_frames=SESSION_FRAMES, n_landmarks=500,
                           seed=10 + s, trajectory="line",
                           camera=default_camera(WIDTH, HEIGHT))
        patches = np.random.default_rng(10 + s + 1).integers(
            40, 255, (500, 11, 11)).astype(np.uint8)
        seqs.append([MapperInput(
            frame=render_frame(world, patches, i, WIDTH, HEIGHT),
            camera=world.camera, track_ids=np.zeros(0, np.int64),
            track_pts=np.zeros((0, 2), np.float32), track_depths=None,
            pose_trail=[Pose(frame_number=j, t=world.times[j],
                             pose_cw=world.odometry_cw[j].copy())
                        for j in range(i, max(-1, i - 6), -1)],
            t=world.times[i]) for i in range(SESSION_FRAMES)])
    return seqs


def phase_sessions(seqs, smi):
    """``map_sequences(device="cuda")``: the sessions concurrently, then the
    first alone on the same frames. Every map passes the audit, and K1 ran
    once per extraction and device quantization of every session."""
    from slam_tpu_torch.ops import bow
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin
    from slam_tpu_torch.parallel.batch import map_sequences
    from slam_tpu_torch.params import Parameters, ParametersSlam
    from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

    params = Parameters(slam=ParametersSlam(**IA_PARAMS))

    def run(sequences):
        torch.cuda.synchronize()
        hamming_argmin.launches = 0
        bow.quantize.device_calls = 0
        t0 = time.perf_counter()
        mappers = map_sequences(sequences, params,
                                n_workers=len(sequences), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for m in mappers:
            check_consistency(m.map_db)
        extractions = sum(m._orb_extractor.extractions for m in mappers)
        launches, quantized = (hamming_argmin.launches,
                               bow.quantize.device_calls)
        assert launches == extractions + quantized > 0, (
            launches, extractions, quantized)
        return mappers, wall, launches
    mappers, wall, launches = run(seqs)
    _, alone_wall, _ = run(seqs[:1])
    agg = SESSIONS * SESSION_FRAMES / wall
    alone = SESSION_FRAMES / alone_wall
    kfs = [len(m.map_db.keyframes) for m in mappers]
    print(f"concurrent sessions: {SESSIONS} x {SESSION_FRAMES} frames at "
          f"{WIDTH}x{HEIGHT} in {wall:.3f} s = {agg:.2f} frames/s aggregate; "
          f"one session alone {alone:.2f} frames/s ({agg / alone:.2f}x); "
          f"keyframes {kfs}; every map consistent; K1 launches {launches} = "
          f"extractions + device quantizations; on {smi}")
    return dict(launches=launches, fps=agg, alone_fps=alone)


def phase_mesh(cam, worlds, images, deltas, smi):
    """``BatchedDeviceVO(mesh=)`` on a mesh that lists the card twice (data
    axis 2), one chunk at the main path's configuration, held to the
    unsharded run; the sharded chunk runs under ``profiling.device_trace``,
    whose trace must hold CUDA kernels and the annotation."""
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.pipeline.device_vo import (BatchedDeviceVO,
                                                   DeviceVOConfig)
    from slam_tpu_torch.utils import profiling

    cfg = DeviceVOConfig(**CFG)
    p0 = np.stack([w.poses_cw[0] for w in worlds]).astype(np.float32)
    mesh = make_mesh(2, devices=["cuda:0", "cuda:0"])
    chunk = (images[:, :CHUNK], deltas[:, :CHUNK])
    plain = BatchedDeviceVO(cfg, batch=S, camera=cam, device="cuda")
    plain.reset(p0)
    want = plain.advance(*chunk)
    sharded = BatchedDeviceVO(cfg, batch=S, camera=cam, mesh=mesh)
    sharded.reset(p0)
    assert len(sharded.shard_devices) == 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.device_trace(str(TRACE_DIR)):
        with profiling.annotate("chip_smoke_mesh_chunk"):
            got = sharded.advance(*chunk)
    wall = time.perf_counter() - t0
    pose_err = float((got.pose_cw - want.pose_cw).abs().max())
    np.testing.assert_allclose(got.pose_cw.cpu().numpy(),
                               want.pose_cw.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(got.n_matched, want.n_matched)
    np.testing.assert_allclose(sharded.state.win_pose_cw.cpu().numpy(),
                               plain.state.win_pose_cw.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    with open(TRACE_DIR / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the trace holds no CUDA kernel"
    assert any(e.get("name") == "chip_smoke_mesh_chunk" for e in events)
    print(f"BatchedDeviceVO(mesh=) S={S} over 2 shards of the card, one "
          f"chunk of {CHUNK} frames: poses within {pose_err:.2e} of the "
          f"unsharded run, n_matched equal; the profiled chunk took "
          f"{wall:.3f} s, its trace holds {len(kernels)} CUDA kernels and "
          f"the annotation; on {smi}")
    return dict(pose_err=pose_err, trace_kernels=len(kernels))


def phase_multichip(smi):
    """``build_update_step`` on a (1, 1) mesh of the card at the
    interactive path's width: 8 frame pairs rendered on a line trajectory
    (the reference test's scene); every pair finds >= 8 essential inliers
    and a finite BA cost."""
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.parallel.multichip import build_update_step
    from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                                visible_landmarks)

    world = make_world(n_frames=4, n_landmarks=300, seed=3,
                       trajectory="line", camera=default_camera(WIDTH, HEIGHT))
    patches = np.random.default_rng(7).integers(40, 255, (300, 9, 9)).astype(
        np.uint8)

    def render(i):
        img = np.full((HEIGHT, WIDTH), 20, np.uint8)
        vis, pix = visible_landmarks(world, i, margin=6.0)
        for li in vis:
            x, y = int(round(pix[li, 0])), int(round(pix[li, 1]))
            y0, y1 = max(0, y - 4), min(HEIGHT, y + 5)
            x0, x1 = max(0, x - 4), min(WIDTH, x + 5)
            img[y0:y1, x0:x1] = patches[li][:y1 - y0, :x1 - x0]
        return img
    images = np.stack([render(i % 4) for i in range(MC_PAIRS)]).astype(
        np.float32)
    mesh = make_mesh(1, axis_names=("data", "hyp"))
    assert dict(mesh.shape) == {"data": 1, "hyp": 1}
    step = build_update_step(mesh, WIDTH, HEIGHT, camera=world.camera,
                             **MC_PARAMS)
    step(images)                                    # warm-up
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(images)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    ess = out.essential_inliers.cpu().numpy()
    cost = out.ba_cost.cpu().numpy()
    print(f"multichip update step, {MC_PAIRS} pairs at {WIDTH}x{HEIGHT} "
          f"{MC_PARAMS}: essential inliers {ess.tolist()}, Sim3 inliers "
          f"{out.sim3_inliers.cpu().numpy().tolist()}, BA cost "
          f"{np.round(cost, 3).tolist()}; {ms:.1f} ms a step; on {smi}")
    assert (ess >= 8).all(), ess
    assert np.isfinite(cost).all(), cost
    return dict(ms=ms)


def _tool(name):
    """A ``tools/torch_*.py`` module, imported as its scripts import each
    other."""
    import importlib

    if str(TOOLS_DIR) not in sys.path:
        sys.path.insert(0, str(TOOLS_DIR))
    return importlib.import_module(name)


def _k1_counts_reset():
    from slam_tpu_torch.ops import bow
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin

    torch.cuda.synchronize()
    hamming_argmin.launches = 0
    bow.quantize.device_calls = 0


def _k1_counts(extractors):
    """K1's launches since ``_k1_counts_reset``, held equal to the
    extractions of ``extractors`` plus the device quantizations."""
    from slam_tpu_torch.ops import bow
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin

    launches = hamming_argmin.launches
    extractions = sum(ex.extractions for ex in extractors)
    quantized = bow.quantize.device_calls
    assert launches == extractions + quantized > 0, (launches, extractions,
                                                     quantized)
    return launches, extractions, quantized


def phase_euroc_synthetic(smi):
    """``tools/torch_run_euroc_synthetic.py``'s run on the card: 240 frames
    of the EuRoC-class room at sigma 0.004 through ``DescriptorTracker`` and
    ``Mapper``. At least one accepted closure, the SLAM trajectory's ATE
    below the odometry's, a consistent map, and K1 launched once per
    extraction (tracker and mapper) and device quantization."""
    from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

    tool = _tool("torch_run_euroc_synthetic")
    _k1_counts_reset()
    t0 = time.perf_counter()
    res, mapper, tracker = tool.drive(
        n_frames=EUROC_FRAMES, drift=EUROC_DRIFT, seed=0, progress=False,
        out=str(BUILD_DIR / "chip_smoke_euroc_traj.csv"),
        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, extractions, quantized = _k1_counts(
        [tracker.extractor, mapper._orb_extractor])
    check_consistency(mapper.map_db)
    print(f"EuRoC-class room, {res['frames']} frames at 752x480, sigma "
          f"{EUROC_DRIFT}: {res['keyframes']} keyframes, {res['map_points']} "
          f"map points, {res['loop_closures']} closures; ATE SLAM "
          f"{res['ate_slam_m']:.6f} m vs odometry {res['ate_odometry_m']:.6f} "
          f"m; render {res['render_ms']:.1f}, track {res['track_ms']:.1f}, "
          f"mapper {res['mapper_ms']:.1f} ms a frame; wall {wall:.1f} s; "
          f"K1 launches {launches} = {extractions} extractions + "
          f"{quantized} device quantizations; map consistent; on {smi}")
    assert res["loop_closures"] >= 1, res
    assert res["ate_slam_m"] < res["ate_odometry_m"], res
    return dict(res, wall=wall, launches=launches)


def phase_device_vo_room(smi):
    """``tools/torch_run_device_vo_euroc.py``'s run on the card: two
    sequences of 120 room frames at sigma 0.008 through ``BatchedDeviceVO``
    with the window BA; its ATE below the odometry's."""
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin

    tool = _tool("torch_run_device_vo_euroc")
    _k1_counts_reset()
    res = tool.run(n_frames=DVO_FRAMES, n_sequences=DVO_SEQS,
                   drift=DVO_DRIFT, window=DVO_WINDOW, progress=False,
                   device="cuda")
    launches = hamming_argmin.launches       # no retrieval: loop_every 0
    print(f"device VO on the room, {DVO_SEQS} x {res['frames']} frames at "
          f"752x480, sigma {DVO_DRIFT}, window {DVO_WINDOW}: ATE "
          f"{res['ate_vo_m_mean']:.6f} m vs odometry "
          f"{res['ate_odometry_m_mean']:.6f} m (per sequence "
          f"{res['per_sequence']}); {res['vo_keyframes_per_sec']:.2f} "
          f"keyframes/s; K1 launches {launches}; on {smi}")
    assert res["ate_vo_m_mean"] < res["ate_odometry_m_mean"], res
    return dict(res, launches=launches)


def phase_kitti_relocation(smi):
    """``tools/torch_run_kitti_synthetic.py`` on the card, cut to the small
    circuit: a blackout with one track reset, the map saved, reloaded as an
    atlas, and a relocation pass in which an atlas candidate reaches
    ``RELOCATION_MAP_POINT_RANSAC``; K1 once per extraction and device
    quantization of both sessions."""
    tool = _tool("torch_run_kitti_synthetic")
    _k1_counts_reset()
    t0 = time.perf_counter()
    res, _, sessions = tool.drive(
        n_frames=KITTI_FRAMES, drift_yaw=KITTI_DRIFT_YAW, radius=KITTI_RADIUS,
        blackout=(KITTI_FRAMES // 2, KITTI_FRAMES // 2 + 4), reloc=True,
        progress=False, map_path=str(KITTI_MAP), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, extractions, quantized = _k1_counts(
        [ex for m, t in sessions for ex in (t.extractor, m._orb_extractor)])
    reloc = res["relocation"]
    print(f"KITTI-class street, {KITTI_FRAMES} frames at 1241x376 (radius "
          f"{KITTI_RADIUS} m, heading bias {KITTI_DRIFT_YAW}): "
          f"{res['keyframes']} keyframes, {res['map_points']} map points, "
          f"{res['loop_closures']} closures, {res['track_resets']} track "
          f"resets; ATE SLAM {res['ate_slam_m']:.6f} m vs odometry "
          f"{res['ate_odometry_m']:.6f} m; loop stats {res['loop_stats']}; "
          f"relocation {reloc}; wall {wall:.1f} s; K1 launches {launches} = "
          f"{extractions} extractions + {quantized} device quantizations; "
          f"on {smi}")
    assert res["track_resets"] == 1, res["track_resets"]
    assert reloc["atlas_keyframes"] == res["keyframes"], reloc
    assert reloc["stages"].get("RELOCATION_MAP_POINT_RANSAC", 0) >= 1, reloc
    return dict(res, wall=wall, launches=launches)


def phase_frontend(images):
    """Frame 0 of every sequence through the front-end on CPU (the plain
    path) and on the card."""
    from slam_tpu_torch.ops.frontend import _operators, extract
    from slam_tpu_torch.ops.pyramid import build_pyramid
    from slam_tpu_torch.pipeline.device_vo import (N_TRACKED, DeviceVOConfig,
                                                   _frontend_spec,
                                                   _resolve_settings)

    cfg = DeviceVOConfig(**CFG)
    spec = _frontend_spec(_resolve_settings(cfg, None), WIDTH, HEIGHT)
    img = torch.from_numpy(images[:, 0])
    out = {}
    for dev in ("cpu", "cuda"):
        x = img.to(dev)
        txy = torch.zeros(S, N_TRACKED, 2, device=dev)
        tv = torch.zeros(S, N_TRACKED, dtype=torch.bool, device=dev)
        _, rs, bs = _operators(spec, x.device)
        levels, blurred = build_pyramid(x.float(), rs, bs)
        out[dev] = ([t.cpu() for t in levels + blurred],
                    extract(x, txy, tv, spec))
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert (a - b).abs().max() <= 1.0
    fc, fg = out["cpu"][1], out["cuda"][1]
    same = ((fc.pts == fg.pts.cpu()).all(-1) & (fc.octave == fg.octave.cpu())
            & (fc.valid == fg.valid.cpu()))
    share = float(same.float().mean())
    print(f"front-end CPU vs card: {share:.4%} of slots equal "
          f"(pts, octave, valid); pyramids within 1 gray")
    assert share >= 0.99, share


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a card")
    t_start = time.perf_counter()
    name, smi = phase_device()
    build_kernels()
    kernel = phase_kernel(smi, mma_peaks(smi))
    cam, worlds, images, deltas = make_inputs()
    main_path = phase_main_path(cam, worlds, images, deltas)
    print(f"main path: {S} sequences x {FRAMES} frames at {WIDTH}x{HEIGHT} in "
          f"{main_path['wall']:.3f} s = {main_path['fps']:.2f} keyframes/s "
          f"on {smi}")
    slam = phase_device_slam(cam, *make_slam_inputs(cam), smi)
    phase_frontend(images)
    ia_inputs = make_interactive_inputs(cam)
    interactive = phase_interactive(cam, *ia_inputs, smi)
    phase_ba_card(smi)
    tracker = phase_tracker(ia_inputs[1], smi)
    sessions = phase_sessions(make_session_inputs(), smi)
    phase_mesh(cam, worlds, images, deltas, smi)
    phase_multichip(smi)
    euroc = phase_euroc_synthetic(smi)
    dvo = phase_device_vo_room(smi)
    kitti = phase_kitti_relocation(smi)
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s, kernel "
          f"builds included; on {smi}")
    k, voc = kernel["main path"], kernel["vocabulary"]
    ia, tt = kernel["interactive"], kernel["tools tracker"]
    print(json.dumps({"kernels": [{
        "name": "hamming_argmin", "route": "cuda",
        "source": "slam_tpu_torch/csrc/hamming_argmin.cu",
        "replaces": "slam_tpu/ops/pallas_kernels.py:52",
        "launches": main_path["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "vocab_ms": voc["ms"], "vocab_plain_ms": voc["plain_ms"],
        "vocab_bound_ms": voc["bound_ms"],
        "device_slam_launches": slam["launches"],
        "interactive_launches": interactive["launches"],
        "interactive_ms": ia["ms"], "interactive_plain_ms": ia["plain_ms"],
        "interactive_bound_ms": ia["bound_ms"],
        "tracker_launches": tracker["launches"],
        "sessions_launches": sessions["launches"],
        "tools_launches": (euroc["launches"] + dvo["launches"]
                           + kitti["launches"]),
        "tools_tracker_ms": tt["ms"], "tools_tracker_plain_ms": tt["plain_ms"],
        "tools_tracker_bound_ms": tt["bound_ms"],
        "tools_tracker_matmul_ms": tt["matmul_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
