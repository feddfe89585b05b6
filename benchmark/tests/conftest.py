"""Shared fixtures of the benchmark's tests: the repo root, and a checkout
of the benchmark with a small room configuration added as files of its own
(a configuration, two traffic mixes, two cells and a dummy metric) that
the harness runs on the CPU."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card (skips without one)")


def _w(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def small_checkout(dst: str) -> str:
    """A checkout at ``dst``: ``BENCHMARK.json`` with two small room cells
    and a dummy metric added, the benchmark's folder with their files
    added, and the program linked in."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    os.symlink(os.path.join(ROOT, "slam_tpu_torch"),
               os.path.join(dst, "slam_tpu_torch"))
    b = os.path.join(dst, "benchmark")
    with open(os.path.join(b, "configs", "euroc-mav.json")) as f:
        c = json.load(f)
    c["name"] = "small-room"
    for k in ("fx", "fy", "cx", "cy"):
        c["camera"][k] /= 2
    c["camera"]["width"], c["camera"]["height"] = 376, 240
    c["scene"]["tex_size"] = 256
    c["device_vo"]["max_keypoints"] = 300
    c["slam"] = {"maxKeypoints": 300}
    _w(os.path.join(b, "configs", "small-room.json"), c)
    for mix, span in (("fleet", [1, 2]), ("live", [2, 4])):
        with open(os.path.join(b, "traffic", f"{mix}.json")) as f:
            t = json.load(f)
        t["trace_span"] = span
        if mix == "fleet":
            t["sequences"], t["chunk"] = 2, 4
        _w(os.path.join(b, "traffic", f"small-{mix}.json"), t)
    with open(os.path.join(b, "cells", "euroc-mav.fleet.json")) as f:
        cf = json.load(f)
    cf["frames"] = 64
    # a CPU window reaches a few chunks only
    cf["sample"].update(chunks=2, chunk_range=[1, 4])
    _w(os.path.join(b, "cells", "small-room.fleet.json"), cf)
    with open(os.path.join(b, "cells", "euroc-mav.live.json")) as f:
        cl = json.load(f)
    cl["frames"], cl["warmup_frames"] = 60, 3
    _w(os.path.join(b, "cells", "small-room.live.json"), cl)
    with open(os.path.join(b, "metrics", "dummy.window_ms.py"), "w") as f:
        f.write('"""The window\'s length (ms): a metric added as a file."""\n'
                "\n\ndef read(rec):\n    return 1e3 * rec['window_s']\n")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["workloads"] += [
        {"name": "small-room.fleet", "config": "small-room",
         "traffic": "small-fleet", "chips": 1, "why": "CPU test"},
        {"name": "small-room.live", "config": "small-room",
         "traffic": "small-live", "chips": 1, "why": "CPU test"}]
    for m in man["end_to_end"] + man["per_layer"]:
        for big, small in (("euroc-mav.fleet", "small-room.fleet"),
                           ("euroc-mav.live", "small-room.live")):
            if big in m.get("workloads", []):
                m["workloads"].append(small)
    man["per_layer"].append(
        {"name": "dummy.window_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "session API",
         "moves": "frames_per_s", "workloads": ["small-room.live"]})
    _w(os.path.join(dst, "BENCHMARK.json"), man)
    return dst


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return small_checkout(str(tmp_path_factory.mktemp("checkout")))
