"""The lazy kernel build (``slam_tpu_torch/kernels/build.load_library``)
under concurrent first calls: several threads that reach one source at the
same time run one compile, and each build writes its own temporary file.
The compiler and the loader are stubbed, so this runs without nvcc."""
import subprocess
import sys
import threading
import time

import pytest

from slam_tpu_torch.kernels import build


@pytest.fixture
def stub_toolchain(tmp_path, monkeypatch):
    calls, outputs = [], []
    lock = threading.Lock()

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with lock:
            calls.append(cmd)
            outputs.append(out)
        time.sleep(0.05)              # a slow compile widens the race
        with open(out, "wb") as f:
            f.write(b"\x7fELF stub")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "_nvcc", lambda: "/stub/nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return calls, outputs


def _race(source, n_threads):
    barrier = threading.Barrier(n_threads)
    results, errors = [], []

    def call():
        barrier.wait()
        try:
            results.append(build.load_library(source))
        except BaseException as exc:     # reported by the assertion below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def test_concurrent_first_calls_build_once(tmp_path, stub_toolchain):
    calls, outputs = stub_toolchain
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    results = _race(str(src), 16)
    assert len(calls) == 1, calls
    assert len(set(results)) == 1 and len(results) == 16
    lib = results[0][1]
    assert lib.endswith(".so") and (tmp_path / "build").exists()
    # the temporary name carries the pid and the thread id
    tmp = outputs[0].rsplit("/", 1)[1].split(".")
    assert tmp[-1] == "tmp" and tmp[-3].isdigit() and tmp[-2].isdigit()


def test_two_sources_build_in_parallel(tmp_path, stub_toolchain):
    calls, _ = stub_toolchain
    srcs = []
    for name in ("a.cu", "b.cu"):
        p = tmp_path / name
        p.write_text(f"// {name}\n")
        srcs.append(str(p))
    done = []
    threads = [threading.Thread(target=lambda s=s: done.append(
        build.load_library(s))) for s in srcs * 4]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == 8 and len(calls) == 2
