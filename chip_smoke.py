"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from ``slam_tpu_torch/csrc``, checks it
bit for bit against its plain PyTorch version on the card, drives the port's
main path (``slam_tpu_torch.pipeline.device_vo.BatchedDeviceVO``) at the
device-SLAM bench's settings, checks the result against the synthetic
ground truth, and compares the front-end on CPU and card. Any failed check
raises, so the exit code is non-zero. Without a CUDA card it exits non-zero
before printing any result.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the kernels' JSON record.
"""
import json
import subprocess
import sys
import time

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


def phase_kernel():
    """K1 against its plain version at the main path's shape and at the
    vocabulary's shape, codebooks with duplicate rows; bit-equal."""
    from slam_tpu_torch.ops.bow import make_codebook
    from slam_tpu_torch.ops.hamming_argmin import (hamming_argmin,
                                                   hamming_argmin_plain)
    from slam_tpu_torch.pipeline.device_vo import _loop_codebook

    rng = np.random.default_rng(0)
    results = {}
    for label, n, cb in [("main path", S * 608, _loop_codebook(512)),
                         ("vocabulary", 4096, make_codebook(65536))]:
        cb = cb.copy()
        v = len(cb)
        cb[v // 2:v // 2 + 32] = cb[:32]          # ties: first match must win
        desc = _near_copies(rng, cb, n, flips=24)
        d = torch.from_numpy(desc.view(np.int32)).cuda()
        c = torch.from_numpy(np.ascontiguousarray(cb).view(np.int32)).cuda()
        kd, ki = hamming_argmin(d, c)
        pd, pi = hamming_argmin_plain(d, c)
        torch.cuda.synchronize()
        err = max(int((kd - pd).abs().max()), int((ki - pi).abs().max()))
        assert torch.equal(kd, pd) and torch.equal(ki, pi), (label, err)
        tied = np.isin(ki.cpu().numpy(), np.arange(v // 2, v // 2 + 32))
        assert not tied.any(), "a duplicated row won over its first copy"
        ms = cuda_time_ms(lambda: hamming_argmin(d, c))
        plain_ms = cuda_time_ms(lambda: hamming_argmin_plain(d, c))
        print(f"hamming_argmin {label} ({n}, 8) x ({v}, 8): bit-equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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
    kernel = phase_kernel()
    cam, worlds, images, deltas = make_inputs()
    main_path = phase_main_path(cam, worlds, images, deltas)
    print(f"main path: {S} sequences x {FRAMES} frames at {WIDTH}x{HEIGHT} in "
          f"{main_path['wall']:.3f} s = {main_path['fps']:.2f} keyframes/s "
          f"on {smi}")
    phase_frontend(images)
    k = kernel["main path"]
    print(json.dumps({"kernels": [{
        "name": "hamming_argmin", "route": "cuda",
        "source": "slam_tpu_torch/csrc/hamming_argmin.cu",
        "replaces": "slam_tpu/ops/pallas_kernels.py:52",
        "launches": main_path["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
