"""The synthetic world of ``tests/synthetic_world.py`` built from the
PyTorch port's classes.

The same source, with ``slam_tpu`` imports rewritten to ``slam_tpu_torch``,
so both packages see the same landmarks, descriptors, poses, simulated
tracks and fake front-end output, each through its own camera,
``MapperInput``, ``Pose`` and ``FrontendResult`` types.
"""
import os
import re
import sys
import types

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "synthetic_world.py")


def _load():
    with open(_SRC) as f:
        src = re.sub(r"\bslam_tpu\b", "slam_tpu_torch", f.read())
    mod = types.ModuleType("torch_synthetic_world_impl")
    mod.__file__ = _SRC
    sys.modules[mod.__name__] = mod      # dataclasses resolve their module
    exec(compile(src, _SRC, "exec"), mod.__dict__)
    return mod


_mod = _load()
SyntheticWorld = _mod.SyntheticWorld
make_world = _mod.make_world
visible_landmarks = _mod.visible_landmarks
TrackSimulator = _mod.TrackSimulator
FakeOrbExtractor = _mod.FakeOrbExtractor
make_mapper_input = _mod.make_mapper_input
