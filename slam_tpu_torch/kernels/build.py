"""nvcc -> shared library -> ctypes, cached by source hash."""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "slam_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# one lock per source: two threads that reach a library first at the same
# time build it once, and builds of different sources still run in parallel
_locks_guard = threading.Lock()
_locks: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source_lock(source: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(source, threading.Lock())


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (or ``source``, if it is an absolute path)
    once per content and load it. Thread-safe: the first caller of a source
    builds it while later callers wait on that source's lock."""
    with _source_lock(source):
        return _load(source)


@functools.lru_cache(maxsize=None)
def _load(source: str) -> ctypes.CDLL:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # pid and thread id: concurrent builds in other processes or
        # threads never write the same file
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
