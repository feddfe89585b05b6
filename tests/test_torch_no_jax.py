"""The port runs without JAX and without the JAX package. In a fresh
interpreter where ``import jax`` and ``import slam_tpu`` fail, every
``slam_tpu_torch`` module and ``chip_smoke.py`` import, and a small VO chunk
runs on the CPU. A subprocess, because this test process has already
imported JAX (tests/conftest.py). No file of the port, nor chip_smoke.py or
tools/profile_torch_vo.py, names ``slam_tpu`` in an import."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
sys.modules["jax"] = None              # any import of jax now raises
sys.modules["slam_tpu"] = None         # and of the JAX package
import importlib, pkgutil
import numpy as np
import torch
import slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(slam_tpu_torch.__path__,
                                               "slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from slam_tpu_torch.pipeline.device_vo import BatchedDeviceVO, DeviceVOConfig
torch.set_num_threads(1)
cfg = DeviceVOConfig(width=160, height=120, lm_capacity=64, max_keypoints=80,
                     window=2, window_ba_every=2, loop_every=1,
                     loop_points=32, loop_words=64)
vo = BatchedDeviceVO(cfg, batch=2, device="cpu")
rng = np.random.default_rng(0)
out = vo.advance(rng.integers(0, 256, (2, 2, 120, 160), dtype=np.uint8),
                 np.broadcast_to(np.eye(4, dtype=np.float32), (2, 2, 4, 4)))
assert out.pose_cw.shape == (2, 2, 4, 4)
assert bool(torch.isfinite(out.pose_cw).all())
for pkg in ("jax", "slam_tpu"):
    loaded = [m for m in sys.modules if m == pkg or m.startswith(pkg + ".")]
    assert loaded == [pkg] and sys.modules[pkg] is None, loaded
print(len(names))
"""


def _imported_roots(path):
    """Top-level names of every import in a Python file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_files():
    files = [os.path.join(dirpath, name)
             for dirpath, _, names in os.walk(os.path.join(ROOT,
                                                           "slam_tpu_torch"))
             for name in names if name.endswith(".py")]
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py"),
                            os.path.join(ROOT, "tools", "profile_torch_vo.py")]


def test_port_files_import_nothing_of_slam_tpu():
    files = _port_files()
    assert len(files) >= 25, files
    bad = {os.path.relpath(f, ROOT): sorted(_imported_roots(f)
                                            & {"slam_tpu", "jax"})
           for f in files}
    assert not any(bad.values()), bad


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the repo only through ``slam_tpu_torch``."""
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert roots == {"concurrent", "ctypes", "json", "pathlib", "subprocess",
                     "sys", "time", "numpy", "torch", "slam_tpu_torch"}, roots


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 15   # every module was imported
