"""The metric arithmetic on made-up records: a tail over all frames, the
busy-union idle share, K1's operations, bytes and roofline share."""
import numpy as np
import pytest

from harness import peaks, spec, stats, trace


def test_percentile_is_numpy_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        v = rng.exponential(size=n).tolist()
        assert stats.percentile(v, 95) == pytest.approx(
            np.percentile(v, 95), rel=1e-12)


def test_latency_tail_covers_every_frame():
    # one 2 s stall among 99 frames of 100 ms: the 95th percentile still
    # reads 100 ms, and five stalls in 100 frames move it
    lat = [0.1] * 99 + [2.0]
    rec = {"kind": "live", "untraced_latencies_s": lat}
    assert spec.reader("frame_latency_p95_ms")(rec) == pytest.approx(100.0)
    rec["untraced_latencies_s"] = [0.1] * 94 + [2.0] * 6
    assert spec.reader("frame_latency_p95_ms")(rec) > 1000.0


def test_union_busy_and_idle():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.6)]
    assert trace.union_busy(iv) == pytest.approx(2.5)
    t = {"busy_s": 2.5, "traced_s": 5.0}
    assert stats.idle_pct(t) == pytest.approx(50.0)
    assert stats.idle_pct(None) is None
    # idle time inside the profiler's buffer flushes leaves the wall: two
    # flushes, one over 0.3 s of idle and one inside busy time
    assert trace.idle_within(iv, [(1.4, 1.8), (2.1, 2.2)]) == \
        pytest.approx(0.3)
    assert stats.idle_pct(dict(t, flush_idle_s=1.0)) == pytest.approx(37.5)
    rec = {"kind": "fleet", "trace": t, "traced_chunks": 5}
    assert spec.reader("fleet.device_idle_pct")(rec) == pytest.approx(50.0)
    assert spec.reader("fleet.chunk_device_ms")(rec) == pytest.approx(500.0)
    assert spec.reader("live.device_idle_pct")(rec) is None


def test_k1_count():
    n, v = 856, 65536
    assert peaks.k1_ops(n, v) == 2 * 856 * 65536 * 256
    assert peaks.k1_bytes(n, v) == 856 * 32 + 65536 * 32 + 856 * 8
    # at the vocabulary's width the operations bound it
    assert peaks.k1_least_s(n, v) == pytest.approx(
        2 * 856 * 65536 * 256 / 1979e12)
    # at one descriptor the bytes do
    assert peaks.k1_least_s(1, v) == pytest.approx(
        (32 + 65536 * 32 + 8) / 3.35e12)


def test_k1_roofline_pairs_calls():
    least = peaks.k1_least_s(856, 65536)
    rec = {"k1_shapes": [], "k1_shapes_setup": [],
           "trace": {"k1_seconds": [4 * least, 4 * least],
                     "k1_shapes_traced": [(856, 65536), (856, 65536)]}}
    assert peaks.k1_roofline_pct(rec) == pytest.approx(25.0)
    # a graph's launches are seen once, at capture: one shape stands in
    rec = {"k1_shapes": [], "k1_shapes_setup": [(4864, 512)],
           "trace": {"k1_seconds": [1e-5] * 3, "k1_shapes_traced": []}}
    assert peaks.k1_roofline_pct(rec) == pytest.approx(
        100 * peaks.k1_least_s(4864, 512) / 1e-5)
    # two shapes and unpaired launches: nothing to read
    rec["k1_shapes_setup"] = [(1, 2), (3, 4)]
    assert peaks.k1_roofline_pct(rec) is None
    assert peaks.k1_roofline_pct({"trace": None}) is None


def test_rates_and_host_spans():
    fleet = {"kind": "fleet", "keyframes": 640, "window_s": 2.0,
             "spans": {"fleet.consume": [0.01, 0.03]}}
    assert spec.reader("keyframes_per_s")(fleet) == 320.0
    assert spec.reader("frames_per_s")(fleet) is None
    assert spec.reader("fleet.consumer_ms")(fleet) == pytest.approx(20.0)
    live = {"kind": "live", "frames": 10, "window_s": 4.0,
            "spans": {"live.tracker": [0.05] * 10,
                      "live.add_frame": [0.2] * 10,
                      "live.extract.mapper": [0.01] * 10},
            "timer": {"local_bundle_adjust": [0.5, 10],
                      "ba_collect_deferred": [0.1, 10],
                      "try_loop_closure": [0.2, 10],
                      "create_new_map_points": [0.3, 10]}}
    assert spec.reader("frames_per_s")(live) == 2.5
    assert spec.reader("live.tracker_ms")(live) == pytest.approx(50.0)
    assert spec.reader("live.local_ba_ms")(live) == pytest.approx(60.0)
    assert spec.reader("live.loop_closer_ms")(live) == pytest.approx(20.0)
    # 200 ms in add_frame, less 10 extraction, 60 BA and 20 closer
    assert spec.reader("live.mapping_ms")(live) == pytest.approx(110.0)
