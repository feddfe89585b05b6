"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own under the benchmark's folder, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: a deployment (camera, scene, trajectory, the
  system's parameters), with its source and what was assumed;
- ``traffic/<traffic>.json``: a traffic mix: which driver runs it
  (``harness/<driver>.py``) and that driver's parameters;
- ``cells/<workload>.json``: what one pair of configuration and mix adds
  (sequence length, odometry error, BA buckets to prewarm, the sampling
  and the limits of the comparison that decides ``correct``);
- ``metrics/<metric>.py``: a reader, ``read(rec) -> float | None``, that
  takes one metric from a run's records.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "configs", f"{name}.json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def cell(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "cells", f"{name}.json"))


def metrics_for(man: dict, cell_name: str, group: str) -> list:
    """The ``group`` ("end_to_end" or "per_layer") metrics this cell
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in man[group]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str, bench_dir: str = BENCH_DIR):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """``harness/<name>.py``, the module that runs a traffic mix."""
    return importlib.import_module(f"harness.{name}")
