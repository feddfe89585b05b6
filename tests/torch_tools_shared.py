"""Helpers of the ``tests/test_torch_*`` files that run both packages: the
JAX package's native library built for the test, the JAX pyramid fed to the
port's front-end, recorders of the trackers' outputs, and the JAX tools'
end-of-session audit."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)


def share_jax_pyramid(monkeypatch):
    """Every port extraction builds its pyramid with the JAX package's band
    matmuls. The two packages' pyramids differ by one gray at a few rint
    ties (ROADMAP section 3), which can reorder nearly equal corners; on a
    shared pyramid the front-ends' slots, descriptors and words are equal."""
    from slam_tpu.ops.pyramid import _build_pyramid_impl, _pyramid_operators
    from slam_tpu_torch.ops import frontend as tfront
    from slam_tpu_torch.params import StaticSettings

    import jax

    scale_key = tuple(float(s) for s in StaticSettings().scaleFactors)
    pyramid = jax.jit(_build_pyramid_impl)

    def shared(image, resize_ops, blur_ops):
        assert len(resize_ops) == len(scale_key) - 1
        H, W = image.shape[-2:]
        _, rs, bs = _pyramid_operators(W, H, scale_key)
        per = [pyramid(jnp.asarray(np.asarray(im), jnp.float32), rs, bs)
               for im in image.cpu()]
        stack = lambda k, j: torch.from_numpy(np.stack(
            [np.array(p[k][j]) for p in per]))
        n = len(per[0][0])
        return ([stack(0, j) for j in range(n)],
                [stack(1, j) for j in range(n)])

    monkeypatch.setattr(tfront, "build_pyramid", shared)


def record_tracks(monkeypatch, tracker_cls):
    """A list that gets each ``tracker_cls.process`` call's tracked ids."""
    seen = []
    process = tracker_cls.process

    def recorded(self, image):
        tf = process(self, image)
        seen.append(np.asarray(tf.tracked_id_list).copy())
        return tf

    monkeypatch.setattr(tracker_cls, "process", recorded)
    return seen


def port_audit_in_jax_mapper(monkeypatch):
    """The JAX ``Mapper.end`` audits with the port's ``check_consistency``:
    the reference's recount keeps an empty covisibility count that the cache
    drops and raises on a sound map (ROADMAP section 3,
    tests/test_torch_map_audit.py)."""
    import slam_tpu.pipeline.mapper as jmapper
    from slam_tpu_torch.pipeline.mapper_helpers import check_consistency

    monkeypatch.setattr(jmapper, "check_consistency", check_consistency)


def reference_native(monkeypatch, tmp_path):
    """The JAX package's native library, built by its own ``_build`` into
    ``tmp_path`` and loaded for this test. The reference builds in place
    (``g++ -o slam_tpu/native/libhostops.so``), so under pytest-xdist a
    worker that loads the file while another worker is writing it reads a
    truncated library and latches "unavailable" (``_tried``) for the rest of
    its life: ``hamming_argmin`` then returns None and the mapper takes its
    NumPy fallbacks, which time other ``utils/timer`` sections. The
    monkeypatch restores the worker's own state after the test."""
    from slam_tpu import native as jnative

    monkeypatch.setattr(jnative, "_LIB_PATH", str(tmp_path / "libhostops.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
    return jnative
