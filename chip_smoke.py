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
card.
Any failed check raises, so the exit code is non-zero. Without a CUDA card
it exits non-zero before printing any result.

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
    for label, n, cb in shapes[:2]:
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
    interactive = phase_interactive(cam, *make_interactive_inputs(cam), smi)
    k, voc = kernel["main path"], kernel["vocabulary"]
    ia = kernel["interactive"]
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
        "interactive_bound_ms": ia["bound_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
