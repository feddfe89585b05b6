"""Every module of the JAX package has its counterpart in the port, at the
same path, with two deliberate renames: ``ops/camera_jax.py`` became
``ops/camera.py``, and the Pallas kernel module ``ops/pallas_kernels.py``
became ``ops/hamming_argmin.py`` (with the binding in ``kernels/`` and the
CUDA source in ``csrc/``). A module added to the JAX package without a
counterpart fails here."""
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAMED = {"ops/camera_jax.py": "ops/camera.py",
           "ops/pallas_kernels.py": "ops/hamming_argmin.py"}


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
