"""Every module of the JAX package has its counterpart in the port, at the
same path, with two deliberate renames: ``ops/camera_jax.py`` became
``ops/camera.py``, and the Pallas kernel module ``ops/pallas_kernels.py``
became ``ops/hamming_argmin.py`` (with the binding in ``kernels/`` and the
CUDA source in ``csrc/``). A module added to the JAX package without a
counterpart fails here.

Within each module, every public name (a function, class or constant at
the top level, and each method of a public class) has a counterpart of the
same name in the port's module, save the deliberate renames and drops
listed below with their reasons. The names are read from the sources, so
nothing here imports either package."""
import ast
import functools
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAMED = {"ops/camera_jax.py": "ops/camera.py",
           "ops/pallas_kernels.py": "ops/hamming_argmin.py"}
# (module, name) -> the port's name for it
RENAMED_NAMES = {
    # the JAX package kept NumPy twins beside its jitted forms; the port's
    # torch functions are the device forms
    ("ops/ransac.py", "decompose_E_jax"): "decompose_E_device",
    ("ops/ransac.py", "triangulate_two_view_jax"): "triangulate_two_view",
    ("ops/ransac.py", "recover_pose_from_E_jax"): "recover_pose_from_E",
}
# (module, name) -> why the port has no counterpart
DROPPED = {
    ("ops/pallas_kernels.py", "TILE_N"):
        "the Pallas grid's TPU tile; the CUDA kernel tiles by its own "
        "constants in csrc/hamming_argmin.cu",
    ("ops/pallas_kernels.py", "TILE_V"):
        "the Pallas grid's TPU tile, as TILE_N",
    ("ops/pallas_kernels.py", "pallas_available"):
        "no optional kernel path: a CUDA tensor launches the kernel or "
        "raises, a CPU tensor takes the plain version",
    ("ops/ba.py", "pack_problem"):
        "the uint32 single-buffer transfer for the TPU's host link; the port "
        "builds the tensors through pinned memory",
    ("ops/ba.py", "fuse_packed"): "the uint32 transfer, as pack_problem",
    ("ops/ba.py", "solve_ba_packed"): "the uint32 transfer, as pack_problem",
    ("ops/ba.py", "solve_ba_two_stage_packed"):
        "the uint32 transfer, as pack_problem",
    ("ops/ba.py", "solve_ba_fused"): "the uint32 transfer, as pack_problem",
    ("ops/ba.py", "solve_ba_two_stage_fused"):
        "the uint32 transfer, as pack_problem",
    ("parallel/multichip.py", "make_key_banks"):
        "JAX PRNG key banks; the port's RANSAC takes its random banks "
        "injected",
    ("utils/timer.py", "TimeStats.start_frame"):
        "set and never read; the port's spans keep their own per-thread "
        "parents instead",
    ("pipeline/device_vo.py", "BatchedDeviceVO._put"):
        "device_put of a chunk's inputs; the port copies them into the "
        "chunk graph's fixed buffers",
    ("ops/frontend.py", "OrbExtractor._tracked_device"):
        "a memo of the tracked points' device copies; the port copies them "
        "from pinned memory into its extraction graph's fixed buffers "
        "(ops/frontend.EXTRACT_GRAPHS) on every call",
}


def _modules(package):
    base = os.path.join(ROOT, package)
    out = []
    for dirpath, _, files in os.walk(base):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), base))
    return sorted(out)


REFERENCE = _modules("slam_tpu")


@functools.lru_cache(maxsize=None)
def _names(path, imported=False):
    """Top-level names a module defines (and, with ``imported``, the names
    it imports) and ``Class.method`` for every method of its public
    classes, private ones included, dunders aside."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef) \
                    and not node.name.startswith("_"):
                names.update(
                    f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("__"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return frozenset(names)


def _public(module):
    return sorted(n for n in _names(os.path.join(ROOT, "slam_tpu", module))
                  if not n.startswith("_"))


def _port_names(module):
    port = os.path.join(ROOT, "slam_tpu_torch", RENAMED.get(module, module))
    return _names(port, imported=True)


PUBLIC = [(m, n) for m in REFERENCE for n in _public(m)]


def test_the_reference_has_modules():
    assert len(REFERENCE) > 50 and "pipeline/device_vo.py" in REFERENCE


@pytest.mark.parametrize("module", REFERENCE)
def test_module_has_a_counterpart(module):
    port = RENAMED.get(module, module)
    assert os.path.exists(os.path.join(ROOT, "slam_tpu_torch", port)), (
        f"slam_tpu/{module} has no counterpart slam_tpu_torch/{port}")


def test_renamed_modules_are_gone_from_the_port():
    for old in RENAMED:
        assert not os.path.exists(os.path.join(ROOT, "slam_tpu_torch", old))


@pytest.mark.parametrize("module,name", PUBLIC,
                         ids=[f"{m}:{n}" for m, n in PUBLIC])
def test_public_name_has_a_counterpart(module, name):
    """The port's module has the name (or its listed rename); a listed drop
    is really absent, so that the list does not outlive a port."""
    port = _port_names(module)
    if (module, name) in DROPPED:
        assert name not in port, (
            f"{module}:{name} is ported; take it off the drop list")
        return
    want = RENAMED_NAMES.get((module, name), name)
    assert want in port, (f"slam_tpu/{module}:{name} has no counterpart "
                          f"{want} in the port")


def test_renames_and_drops_name_public_names():
    for module, name in list(RENAMED_NAMES) + list(DROPPED):
        assert (module, name) in PUBLIC, (module, name)
