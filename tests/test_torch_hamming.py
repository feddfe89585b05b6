"""Parity of the torch port's Hamming ops with the JAX package on CPU, and
the hamming_argmin wrapper's dispatch: bit-equal distance matrices,
mutual-NN picks (with and without the Lowe test) and first-match argmins,
including codebooks with duplicate rows. One case runs the CUDA kernel and
needs a card; the machine with the card has no JAX, so the JAX reference
is imported inside the parity tests and that case runs there with

    python -m pytest tests/test_torch_hamming.py --noconftest -m cuda
"""
import importlib

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops import hamming as tham
from slam_tpu_torch.ops.hamming_argmin import (hamming_argmin,
                                               hamming_argmin_plain)

torch.set_num_threads(1)


def _jax_reference():
    """(jax.numpy, slam_tpu.ops.hamming, THR_LOW, Pallas hamming_argmin)."""
    jnp = importlib.import_module("jax.numpy")
    jham = importlib.import_module("slam_tpu.ops.hamming")
    matching = importlib.import_module("slam_tpu.ops.matching")
    pallas = importlib.import_module("slam_tpu.ops.pallas_kernels")
    return jnp, jham, matching.HAMMING_DIST_THR_LOW, pallas.hamming_argmin


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _t(desc_u32):
    """uint32 words -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(desc_u32).view(np.int32))


def _near_copies(rng, base, n, flips):
    """Rows of ``base`` with ``flips`` random bits flipped: realistic
    near-duplicates so thresholds, ties and mutual checks are exercised."""
    out = base[rng.integers(0, len(base), n)].copy()
    for row in out:
        for b in rng.integers(0, 256, flips):
            row[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _codebook_with_ties(rng, v):
    cb = _desc(rng, v)
    cb[v // 2:v // 2 + 16] = cb[:16]            # exact duplicate rows
    cb[-1] = cb[3]
    return cb


def test_unpack_bits_matches_jax():
    jnp, jham, _, _ = _jax_reference()
    d = _desc(np.random.default_rng(0), 16)
    want = np.asarray(jham.unpack_bits_pm1(jnp.asarray(d)))
    np.testing.assert_array_equal(tham.unpack_bits_pm1(_t(d)).numpy(),
                                  want.astype(np.float32))


def test_hamming_matrix_bit_equal():
    jnp, jham, _, _ = _jax_reference()
    rng = np.random.default_rng(1)
    a, b = _desc(rng, 97), _desc(rng, 130)
    a[:5] = b[:5]                                # distance 0
    a[5] = ~b[5]                                 # distance 256
    want = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_matrix(_t(a), _t(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jham.hamming_matrix_host(a, b))
    # batched form: a leading sequence dimension
    got_b = tham.hamming_matrix(_t(np.stack([a, a])), _t(np.stack([b, b])))
    np.testing.assert_array_equal(got_b.numpy(), np.stack([want, want]))


@pytest.mark.parametrize("ratio", [1.0, 0.8])
def test_mutual_nn_bit_equal(ratio):
    jnp, jham, HAMMING_DIST_THR_LOW, _ = _jax_reference()
    rng = np.random.default_rng(2)
    b = _desc(rng, 120)
    a = _near_copies(rng, b, 100, flips=20)
    dist = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    gate = rng.random(dist.shape) < 0.7
    dist = np.where(gate, dist, jham.MASK_DIST).astype(np.int32)
    dist[:, 7] = dist[:, 8]                       # column ties
    j_nn, j_ok = (np.asarray(x) for x in jham.mutual_nn(
        jnp.asarray(dist), HAMMING_DIST_THR_LOW, ratio=ratio))
    t_nn, t_ok = tham.mutual_nn(torch.from_numpy(dist),
                                tham.HAMMING_DIST_THR_LOW, ratio=ratio)
    np.testing.assert_array_equal(t_nn.numpy(), j_nn)
    np.testing.assert_array_equal(t_ok.numpy(), j_ok)
    assert 10 < j_ok.sum() < len(a)


def test_constants_match_jax():
    _, jham, HAMMING_DIST_THR_LOW, _ = _jax_reference()
    assert tham.HAMMING_DIST_THR_LOW == HAMMING_DIST_THR_LOW
    assert tham.MASK_DIST == jham.MASK_DIST


def test_match_thresholds_match_jax():
    """The host map layer's thresholds, which the port's copies of
    ``ops/matching`` and ``pipeline/matcher`` import."""
    _, jham, _, _ = _jax_reference()
    assert tham.HAMMING_DIST_THR_HIGH == jham.HAMMING_DIST_THR_HIGH == 100
    assert tham.MAX_HAMMING_DIST == jham.MAX_HAMMING_DIST == 256


@pytest.mark.parametrize("n,v", [(300, 512), (37, 1024)])
def test_hamming_argmin_plain_matches_pallas_and_host(n, v):
    _, jham, _, pallas_hamming_argmin = _jax_reference()
    rng = np.random.default_rng(3)
    cb = _codebook_with_ties(rng, v)
    desc = np.concatenate([_near_copies(rng, cb, n - 5, flips=30),
                           cb[:5]])               # exact hits on tied rows
    want_d, want_i = pallas_hamming_argmin(desc, cb, interpret=True)
    host = jham.hamming_matrix_host(desc, cb)
    d, i = hamming_argmin(_t(desc), _t(cb))      # CPU tensors: plain path
    assert d.dtype == torch.int32 and i.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(i.numpy(), np.argmin(host, axis=1))
    np.testing.assert_array_equal(d.numpy(), host.min(axis=1))
    # first match wins on the duplicated rows
    assert (i.numpy()[-5:] == np.arange(5)).all()


def test_make_codebook_is_the_trained_vocabulary():
    """The port loads the in-tree vocabulary the JAX package loads, and
    where no trained vocabulary of that size exists (or another seed is
    asked for) the same seeded random centroids."""
    from slam_tpu_torch.ops.bow import make_codebook

    jbow = importlib.import_module("slam_tpu.ops.bow")
    np.testing.assert_array_equal(make_codebook(65536),
                                  jbow.make_codebook(65536))
    for v, seed in ((1000, 94235682), (512, 7)):
        np.testing.assert_array_equal(make_codebook(v, seed),
                                      jbow.make_codebook(v, seed))
    assert make_codebook(1000).shape == (1000, 8)


def test_hamming_argmin_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(4)
    before = hamming_argmin.launches
    hamming_argmin(_t(_desc(rng, 4)), _t(_desc(rng, 128)))
    assert hamming_argmin.launches == before


@pytest.mark.cuda
def test_hamming_argmin_kernel_bit_equal_on_card():
    """The CUDA kernel against its plain version on the card: the main
    path's and the vocabulary's shapes, ragged N and V, and duplicate
    codebook rows on both sides of every 64-row boundary (so of every
    cluster rank's first row, for any split into whole tiles of 64 rows),
    where the first index must win. One launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")

    rng = np.random.default_rng(5)
    for n, v in [(1, 1), (300, 512), (2432, 512), (1, 512), (2433, 512),
                 (300, 1), (2432, 513), (1000, 1000), (129, 65535),
                 (4096, 65536)]:
        cb = _codebook_with_ties(rng, v) if v >= 32 else _desc(rng, v)
        cb[64::64] = cb[63:-1:64]                # row 64k repeats row 64k - 1
        tied = list(range(63, v - 1, 64))
        desc = _near_copies(rng, cb, n, flips=40)
        desc[:len(tied)] = cb[tied][:n]
        first = [np.flatnonzero((cb == cb[j]).all(1))[0] for j in tied]
        dc, cc = _t(desc).cuda(), _t(cb).cuda()
        before = hamming_argmin.launches
        d, i = hamming_argmin(dc, cc)
        assert hamming_argmin.launches == before + 1
        pd, pi = hamming_argmin_plain(dc, cc)
        torch.cuda.synchronize()
        assert torch.equal(d, pd) and torch.equal(i, pi), (n, v)
        assert (i[:len(tied)].cpu().numpy() == first[:n]).all(), (n, v)
    d, i = hamming_argmin(dc[:0], cc)
    assert d.shape == i.shape == (0,)
    with pytest.raises(ValueError):
        hamming_argmin(dc, _t(_desc(rng, 65537)).cuda())
