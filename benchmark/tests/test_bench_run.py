"""The harness run end to end on the CPU at a small size, in a checkout
with a cell, its configuration, mixes and a dummy metric added as files
only; and its refusal without a card."""
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH

RUN = """
import json, sys
sys.path.insert(0, {bench!r})
import torch
torch.set_num_threads(4)
{fault}
import run
out = run.run_cell({root!r}, {cell!r}, {seed}, {seconds}, {trace},
                   device="cpu", bench_dir={root!r} + "/benchmark")
out["forbidden"] = run.loaded_forbidden()
print(json.dumps(out))
"""


def run_small(root, cell, seed, seconds, trace, fault=""):
    if fault:
        fault = (f"sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
                 f"import faults; faults.{fault}()")
    code = RUN.format(bench=BENCH, root=root, cell=cell, seed=seed,
                      seconds=seconds, trace=trace, fault=fault)
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=1500,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


def test_live_cell_with_a_dummy_metric(checkout):
    out, err = run_small(checkout, "small-room.live", 2 ** 33 + 7, 30, True)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert out["correct"] is True and out["failed"] == 0, err[-2000:]
    assert out["attempted"] > 4
    m = out["metrics"]
    assert m["dummy.window_ms"]["unit"] == "ms"
    assert m["dummy.window_ms"]["value"] >= 30000
    for name in ("live.tracker_ms", "live.mapping_ms", "live.local_ba_ms",
                 "live.loop_closer_ms"):
        assert m[name]["value"] >= 0
    assert "frames_per_s" not in m                      # traced run
    d = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(d)
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-2] == "checks"
    assert set(out["checks"]) == {"false_closures", "word_mismatches",
                                  "map_pose_gap_m", "map_point_gap_m"}
    assert out["forbidden"] == []
    assert err.strip().splitlines()[-1].startswith("check ")


def test_fleet_cell_end_to_end(checkout):
    out, err = run_small(checkout, "small-room.fleet", 11, 15, False)
    assert out["correct"] is True, err[-2000:]
    assert {"pose_lm_gap_m", "word_mismatches"} <= set(out["checks"])
    assert set(out["metrics"]) == {"keyframes_per_s", "setup_s"}
    assert out["attempted"] % 2 == 0 and out["attempted"] >= 16
    assert out["forbidden"] == []


def test_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(BENCH)
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "euroc-mav.fleet", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no result."""
    import shutil

    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"),
                tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "euroc-mav.live", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    """``slam_tpu_torch`` begins with ``slam_tpu`` and must pass; the JAX
    package, ``jax``, ``jaxlib`` and ``flax`` must not."""
    import types

    sys.path.insert(0, BENCH)
    import run

    for name in ("slam_tpu_torch", "slam_tpu_torch.ops", "jax_like",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "slam_tpu")]:
        monkeypatch.delitem(sys.modules, name)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "slam_tpu.ops.ba",
                        types.ModuleType("slam_tpu.ops.ba"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    assert run.loaded_forbidden() == ["jaxlib", "slam_tpu"]
