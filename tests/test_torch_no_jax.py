"""The port runs without JAX and without the JAX package. In a fresh
interpreter where ``import jax`` and ``import slam_tpu`` fail, every
``slam_tpu_torch`` module and ``chip_smoke.py`` import, and on the CPU a
small ``DeviceSlam`` session (two VO chunks and the host consumer) and a
small interactive ``Slam`` session (real ORB extractor, four rendered
frames) run. A subprocess, because this test process has already
imported JAX (tests/conftest.py). No file of the port, nor chip_smoke.py or
the port's tools, names ``slam_tpu`` in an import."""
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
assert {"slam_tpu_torch.pipeline.device_slam",
        "slam_tpu_torch.pipeline.loop_closer",
        "slam_tpu_torch.ops.sim3_opt", "slam_tpu_torch.pipeline.slam_api",
        "slam_tpu_torch.pipeline.mapper", "slam_tpu_torch.native",
        "slam_tpu_torch.map.mapdb",
        "slam_tpu_torch.frontends.descriptor_tracker",
        "slam_tpu_torch.parallel.batch", "slam_tpu_torch.parallel.mesh",
        "slam_tpu_torch.parallel.multichip", "slam_tpu_torch.utils.profiling",
        "slam_tpu_torch.utils.viewer", "slam_tpu_torch.utils.viz2d"
        } <= set(names), names
import chip_smoke
# the port's tools, with every original tool and bench.py blocked too
for name in ORIGINAL_TOOLS:
    sys.modules[name] = None
sys.path.insert(0, "tools")
for name in TOOL_TWINS:
    importlib.import_module(name)
from slam_tpu_torch import DeviceSlam, DeviceSlamParams
from slam_tpu_torch.pipeline.device_vo import DeviceVOConfig
torch.set_num_threads(1)
cfg = DeviceVOConfig(width=160, height=120, lm_capacity=64, max_keypoints=80,
                     window=2, window_ba_every=2, loop_every=1,
                     loop_points=32, loop_words=64, loop_min_gap=1)
slam = DeviceSlam(cfg, batch=2, params=DeviceSlamParams(min_loop_score=0.0,
                                                        min_closure_gap_s=0),
                  device="cpu")
rng = np.random.default_rng(0)
img = rng.integers(0, 256, (2, 2, 120, 160), dtype=np.uint8)
eye = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 2, 4, 4))
for _ in range(2):
    out = slam.advance(img, eye)
slam.finish()
assert out.pose_cw.shape == (2, 2, 4, 4)
assert bool(torch.isfinite(out.pose_cw).all())
assert slam.trajectory(1).shape == (4, 4, 4)
assert slam.closures                    # the consumer tried the revisits
# the interactive path: a Slam session with the real ORB extractor (fused
# words at the 65,536-word vocabulary), BA and the loop closer on the CPU
from slam_tpu_torch.map.keyframe import Pose
from slam_tpu_torch.params import Parameters, ParametersSlam
from slam_tpu_torch.pipeline.slam_api import Slam
from slam_tpu_torch.utils.synthetic import (default_camera, make_world,
                                            render_frame)
cam = default_camera(160, 120)
world = make_world(n_frames=4, n_landmarks=200, seed=3, camera=cam)
patches = rng.integers(40, 255, (200, 11, 11)).astype(np.uint8)
session = Slam.build(Parameters(slam=ParametersSlam(
    maxKeypoints=120, keyframeDecisionMinIntervalSeconds=0.0,
    useFrontendSlam=False)), device="cpu")
futures = [session.add_frame(
    frame=render_frame(world, patches, i, 160, 120),
    pose_trail=[Pose(frame_number=j, t=world.times[j],
                     pose_cw=world.poses_cw[j].copy())
                for j in range(i, max(-1, i - 4), -1)],
    features_ids=np.zeros(0, np.int64),
    features_pts=np.zeros((0, 2), np.float32), camera=cam)
    for i in range(4)]
assert all(f.result().pose_mat.shape == (4, 4) for f in futures)
assert session.end().result()
assert session.mapper.map_db.keyframes
assert session.mapper._orb_extractor.extractions >= 1
# the multi-device update step over two CPU devices
from slam_tpu_torch.parallel.mesh import make_mesh
from slam_tpu_torch.parallel.multichip import build_update_step
step = build_update_step(make_mesh(2, devices=["cpu", "cpu"]), 96, 80,
                         hypotheses=8, ba_capacity=8)
mc = step(rng.integers(0, 256, (2, 80, 96)).astype(np.float32))
assert bool(torch.isfinite(mc.ba_cost).all())
for pkg in ("jax", "slam_tpu") + ORIGINAL_TOOLS:
    loaded = [m for m in sys.modules if m == pkg or m.startswith(pkg + ".")]
    assert loaded == [pkg] and sys.modules[pkg] is None, loaded
print(len(names))
"""


# the rendered-sequence tools' twins, and what they must not import
TOOL_TWINS = ("torch_run_euroc_synthetic", "torch_run_device_vo_euroc",
              "torch_sweep_device_vo", "torch_run_kitti_synthetic",
              "torch_profile_pipeline", "torch_eval_vocab_transfer",
              "torch_run_euroc", "torch_run_kitti")
ORIGINAL_TOOLS = ("bench", "run_euroc_synthetic", "run_device_vo_euroc",
                  "sweep_device_vo", "run_kitti_synthetic", "profile_pipeline",
                  "eval_vocab_transfer", "run_euroc", "run_kitti",
                  "train_vocab", "synthetic_world")
PROBE = ("TOOL_TWINS = %r\nORIGINAL_TOOLS = %r\n" % (TOOL_TWINS,
                                                     ORIGINAL_TOOLS)
         + PROBE)


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
    tools = [os.path.join(ROOT, "tools", name + ".py")
             for name in ("profile_torch_vo", "torch_seed_spread")
             + TOOL_TWINS]
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")] + tools


def test_port_files_import_nothing_of_slam_tpu():
    files = _port_files()
    assert len(files) >= 25, files
    assert all(os.path.exists(f) for f in files)
    bad = {os.path.relpath(f, ROOT): sorted(
        _imported_roots(f) & {"slam_tpu", "jax", *ORIGINAL_TOOLS})
        for f in files}
    assert not any(bad.values()), bad


def test_tool_twins_import_only_numpy_torch_and_the_port():
    """Each ``tools/torch_*`` twin imports the standard library, numpy,
    torch (or PIL, to decode dataset frames), the port and other twins."""
    import sys as _sys

    allowed = {"numpy", "torch", "PIL", "slam_tpu_torch", *TOOL_TWINS,
               *_sys.stdlib_module_names}
    for name in TOOL_TWINS:
        roots = _imported_roots(os.path.join(ROOT, "tools", name + ".py"))
        assert roots <= allowed, (name, roots - allowed)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the repo only through ``slam_tpu_torch`` and
    the port's tools."""
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert roots == {"concurrent", "ctypes", "importlib", "json", "pathlib",
                     "subprocess", "sys", "time", "numpy", "torch",
                     "slam_tpu_torch"}, roots


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 40   # every module was imported
