"""The port's concurrent sessions and trace capture, on CPU:
``parallel/batch.map_sequences`` (the reference's ``TestBatchSequences``,
tests/test_native_and_misc.py:390-418, with every session's ``Mapper`` on
the device given; and each session held to the JAX package's
``map_sequences`` on the same inputs: the same keyframes and map-point
counts, keyframe poses within 1e-4), the launch counters under concurrent
callers, and ``utils/profiling`` (the trace file exists and holds the
annotation)."""
import json
import os
import sys
import threading

import numpy as np
import torch

import synthetic_world as jworld
import torch_synthetic_world as tworld
from slam_tpu_torch.parallel.batch import map_sequences
from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

torch.set_num_threads(1)
N_FRAMES = 10
SESSION = dict(useFrontendSlam=False, minVisibleMapPointsInCurrentFrameBA=8,
               localBAProblemSize=12, adjacentSpaceSize=8)


def _sessions(world_mod, map_fn, params, **kw):
    """Two sequences through ``map_fn`` with the fake extractor."""
    worlds = [world_mod.make_world(n_frames=N_FRAMES, n_landmarks=150, seed=s)
              for s in (1, 2)]
    trackers = [world_mod.TrackSimulator(w) for w in worlds]
    sequences = [[world_mod.make_mapper_input(w, f, t)
                  for f in range(N_FRAMES)]
                 for w, t in zip(worlds, trackers)]
    return map_fn(
        sequences, params,
        orb_extractor_factory=lambda i: world_mod.FakeOrbExtractor(
            worlds[i], trackers[i]), **kw)


class TestBatchSequences:
    def test_two_sequences_concurrently(self):
        mappers = _sessions(tworld, map_sequences,
                            Parameters(slam=ParametersSlam(**SESSION)),
                            device="cpu")
        assert len(mappers) == 2
        for m in mappers:
            assert len(m.map_db.keyframes) >= 3
            check_consistency(m.map_db)
            assert m.device.type == "cpu"
        # sessions are fully independent maps
        assert mappers[0].map_db is not mappers[1].map_db

    def test_sessions_match_jax(self):
        from slam_tpu.parallel.batch import map_sequences as jmap_sequences
        from slam_tpu.params import Parameters as JParameters
        from slam_tpu.params import ParametersSlam as JParametersSlam

        jax_maps = _sessions(jworld, jmap_sequences,
                             JParameters(slam=JParametersSlam(**SESSION)))
        port_maps = _sessions(tworld, map_sequences,
                              Parameters(slam=ParametersSlam(**SESSION)),
                              device="cpu")
        assert len(port_maps) == len(jax_maps) == 2
        for tm, jm in zip(port_maps, jax_maps):
            assert sorted(tm.map_db.keyframes) == sorted(jm.map_db.keyframes)
            assert len(tm.map_db.map_points) == len(jm.map_db.map_points)
            for k, kf in tm.map_db.keyframes.items():
                np.testing.assert_allclose(
                    kf.pose_cw, jm.map_db.keyframes[k].pose_cw, atol=1e-4)


def test_launch_counter_loses_no_update(monkeypatch):
    """Concurrent sessions count device quantizations from many threads:
    32 threads x 4 calls with a 1 us switch interval add exactly 128."""
    from slam_tpu_torch import native
    from slam_tpu_torch.ops import bow

    # the size threshold without the native scan: 512 x 512 takes the
    # device branch, here through the plain argmin on CPU tensors
    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(0)
    codebook = rng.integers(0, 2 ** 32, (512, 8), dtype=np.uint32)
    desc = rng.integers(0, 2 ** 32, (512, 8), dtype=np.uint32)
    want = bow.quantize(desc, codebook, "cpu")
    start = bow.quantize.device_calls
    barrier = threading.Barrier(32)
    wrong = []

    def call():
        barrier.wait()
        for _ in range(4):
            if not np.array_equal(bow.quantize(desc, codebook, "cpu"), want):
                wrong.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not wrong
    assert bow.quantize.device_calls - start == 128


def test_device_trace_holds_the_annotation(tmp_path):
    from slam_tpu_torch.utils.profiling import TRACE_FILE, annotate, \
        device_trace

    with device_trace(str(tmp_path), device="cpu"):
        with annotate("slam_tpu_torch_probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(str(tmp_path), TRACE_FILE)
    assert os.path.exists(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "slam_tpu_torch_probe" for e in events)
