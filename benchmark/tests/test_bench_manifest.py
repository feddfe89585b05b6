"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT_MAX = 200


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= TEXT_MAX and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths(man):
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(man["command"]) <= 32
    assert all(_text(w) for w in man["command"])
    files = [w for w in man["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in man["paths"])
                         for f in files)


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(man, group):
    names = [e["name"] for e in man[group]]
    assert len(names) == len(set(names))
    for e in man[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metric_names_unique_across_groups(man):
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))


def test_configs(man):
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_workloads_find_their_files(man):
    pairs = set()
    configs = {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _text(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for sub, name in (("traffic", w["traffic"]), ("cells", w["name"])):
            assert os.path.isfile(os.path.join(BENCH, sub, f"{name}.json"))
        with open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.isfile(os.path.join(BENCH, "harness", f"{driver}.py"))
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(
        1, len(man["workloads"]) // 4)


def test_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in man["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for c in m["workloads"]:
            assert c in cells
            assert "workloads" not in moved or c in moved["workloads"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_every_cell_reports_enough(man):
    for w in man["workloads"]:
        e2e = [m for m in man["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        layer = [m for m in man["per_layer"] if w["name"] in m["workloads"]]
        assert any(m["name"] == "setup_s" for m in e2e)
        assert len(e2e) >= 2 and layer


def test_run_seconds_fit_the_check(man):
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_readers_load(man):
    from harness import spec

    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(spec.reader(m["name"]))
