"""The port's counterparts of three public names of the JAX package, held
to the originals on the CPU with numpy-seeded inputs: ``ImagePyramid``
(slam_tpu/ops/pyramid.py), ``hamming_matrix_popcount`` and
``hamming_distance`` (slam_tpu/ops/hamming.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import hamming as jham
from slam_tpu.ops import pyramid as jpyr
from slam_tpu.params import StaticSettings as JaxSettings
from slam_tpu_torch.ops import hamming as tham
from slam_tpu_torch.ops import pyramid as tpyr
from slam_tpu_torch.params import StaticSettings

torch.set_num_threads(1)


def _descriptors(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


@pytest.mark.parametrize("size", [(128, 96), (160, 120)])
def test_image_pyramid_matches_jax(size):
    """Level sizes equal; every level and blurred level within one gray of
    the JAX package's (the band matmuls round apart at a few pixels), and
    bit-equal to the port's own ``build_pyramid``."""
    w, h = size
    img = np.random.default_rng(w).integers(0, 256, (h, w)).astype(np.uint8)
    want = jpyr.ImagePyramid(JaxSettings(), w, h).update(img)
    got = tpyr.ImagePyramid(StaticSettings(), w, h, device="cpu").update(img)
    assert got.sizes == want.sizes and got.num_levels == want.num_levels
    for a, b in zip(want.levels + want.blurred, got.levels + got.blurred):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1.0
        assert np.mean(a != b) < 1e-3
    _, rs, bs = tpyr.device_operators(w, h, got.scale_factors,
                                      torch.device("cpu"))
    lv, bl = tpyr.build_pyramid(torch.from_numpy(img).float(), rs, bs)
    for a, b in zip(lv + bl, got.levels + got.blurred):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        got.update(img[:-1])


def test_hamming_matrix_popcount_matches_jax():
    """Equal to the JAX package's XOR-and-popcount matrix and to the port's
    matmul form, on random words and on words with the top bit set."""
    rng = np.random.default_rng(5)
    a, b = _descriptors(rng, 37), _descriptors(rng, 53)
    a[:5] = 0xFFFFFFFF
    b[:3] = 0x80000000
    want = np.asarray(jham.hamming_matrix_popcount(jnp.asarray(a),
                                                   jnp.asarray(b)))
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    got = tham.hamming_matrix_popcount(ta, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  tham.hamming_matrix(ta, tb).numpy())


def test_hamming_distance_matches_jax():
    """Row by row and for one pair of descriptors."""
    rng = np.random.default_rng(6)
    a, b = _descriptors(rng, 20), _descriptors(rng, 20)
    np.testing.assert_array_equal(tham.hamming_distance(a, b),
                                  jham.hamming_distance(a, b))
    assert tham.hamming_distance(a[0], b[0]) == jham.hamming_distance(a[0],
                                                                      b[0])
    assert tham.hamming_distance(a[0], a[0]) == 0
