"""The port's copies of the JAX package's host modules are the reference's
source with only the imports rewritten (``slam_tpu`` -> ``slam_tpu_torch``).

One difference is allowed, in ``native/__init__.py``: the reference builds
``libhostops.so`` into its package directory, the port builds it into the
git-ignored ``build/slam_tpu_torch/`` under a name keyed by the source hash,
the flags and the host CPU. Every other top-level definition of that module
is the reference's; ``hostops.cpp`` is a byte copy.

``utils/timer.py`` is no longer a copy: the port's timer records spans,
counters and device durations. It keeps every public name of the
reference's, save ``TimeStats.start_frame``, which the reference sets and
never reads."""
import ast
import os
import re

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = ["ids.py", "utils/stats.py", "utils/commands.py",
          "utils/ascii_viz.py", "geometry/triangulation.py",
          "map/__init__.py", "map/feature_search.py", "map/mp_store.py",
          "map/map_point.py", "map/keyframe.py", "map/mapdb.py",
          "map/serialization.py", "ops/matching.py", "pipeline/adjacency.py",
          "params.py", "geometry/camera.py", "geometry/se3.py",
          "utils/viewer.py", "utils/viz2d.py", "frontends/__init__.py",
          "parallel/__init__.py"]

# native/__init__.py: the build location and how it is keyed
NATIVE_BUILD_NAMES = {"_LIB_PATH", "_FLAGS", "_BUILD_DIR", "_cpu_model",
                      "_lib_path", "_build", "get_lib"}


def _read(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


def _rewrite(src):
    return re.sub(r"\bslam_tpu\b(?!_torch)", "slam_tpu_torch", src)


@pytest.mark.parametrize("module", COPIES)
def test_module_is_the_reference_with_imports_rewritten(module):
    assert (_read(os.path.join("slam_tpu_torch", module))
            == _rewrite(_read(os.path.join("slam_tpu", module))))


def _top_level(src):
    """{name: source} of every top-level statement that binds a name, and
    the module docstring under ``__doc__``."""
    tree = ast.parse(src)
    out = {"__doc__": ast.get_docstring(tree)}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.unparse(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                out[ast.unparse(t)] = ast.unparse(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out[ast.unparse(node)] = ast.unparse(node)
    return out


def test_native_differs_only_in_its_build_location():
    ref = _top_level(_rewrite(_read("slam_tpu/native/__init__.py")))
    port = _top_level(_read("slam_tpu_torch/native/__init__.py"))
    assert set(ref) - NATIVE_BUILD_NAMES == set(port) - NATIVE_BUILD_NAMES
    for name in set(ref) - NATIVE_BUILD_NAMES:
        assert port[name] == ref[name], name
    # the named difference: the port never writes into its package
    assert "_LIB_PATH" in ref and "_LIB_PATH" not in port
    assert "build" in port["_BUILD_DIR"]


def test_timer_keeps_the_reference_names():
    ref = _top_level(_rewrite(_read("slam_tpu/utils/timer.py")))
    port = _top_level(_read("slam_tpu_torch/utils/timer.py"))
    public = {n for n in ref if not n.startswith(("_", "import", "from"))}
    assert public <= set(port), public - set(port)
    from slam_tpu_torch.utils import timer

    methods = {"time", "table", "reset"}
    assert all(callable(getattr(timer.TimeStats, m)) for m in methods)
    assert not hasattr(timer.TimeStats, "start_frame")


def test_native_source_is_a_byte_copy():
    with open(os.path.join(ROOT, "slam_tpu/native/hostops.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "slam_tpu_torch/native/hostops.cpp"),
                 "rb") as b:
        assert a.read() == b.read()


def test_native_builds_outside_the_package_and_agrees(monkeypatch,
                                                      tmp_path):
    """The port's library builds under build/slam_tpu_torch/ and computes
    what the reference's does (built for this test: ``reference_native``)."""
    from torch_tools_shared import reference_native

    from slam_tpu_torch import native as tnative

    jnative = reference_native(monkeypatch, tmp_path)

    assert tnative.available()
    assert os.path.dirname(tnative._lib_path()) == os.path.join(
        ROOT, "build", "slam_tpu_torch")
    assert not os.path.exists(os.path.join(ROOT, "slam_tpu_torch", "native",
                                           "libhostops.so"))
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    np.testing.assert_array_equal(tnative.hamming_matrix(a, b),
                                  jnative.hamming_matrix(a, b))
    np.testing.assert_array_equal(tnative.hamming_argmin(a, b),
                                  jnative.hamming_argmin(a, b))
    assert tnative.medoid_descriptor(b) == jnative.medoid_descriptor(b)
