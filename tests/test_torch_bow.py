"""Parity of the port's BoW layer (``ops/bow``) with the JAX package on CPU:
the codebook (trained vocabulary, explicit path and seeded fallback), the
quantized words at the 65,536-word vocabulary with duplicated codebook
rows (first index on ties; exact integers, so equality), both sides of the
size threshold, and the inverted index built from them."""
import importlib

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops import bow as tbow
from slam_tpu_torch.params import ParametersSlam

torch.set_num_threads(1)


def _near_copies(rng, base, n, flips):
    out = base[rng.integers(0, len(base), n)].copy()
    for row in out:
        for b in rng.integers(0, 256, flips):
            row[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _tied_vocabulary():
    """The trained vocabulary with exact duplicates of rows 0-15 at rows
    40000-40015 and of row 7 at the last row."""
    cb = tbow.make_codebook(65536).copy()
    cb[40000:40016] = cb[:16]
    cb[-1] = cb[7]
    return cb


def test_codebook_path_and_seeds_equal_the_reference(tmp_path):
    jbow = importlib.import_module("slam_tpu.ops.bow")
    path = str(tmp_path / "v.npz")
    vocab = np.random.default_rng(3).integers(0, 2 ** 32, (256, 8),
                                              dtype=np.uint32)
    np.savez(path, codebook=vocab)
    np.testing.assert_array_equal(tbow.make_codebook(256, path=path), vocab)
    np.testing.assert_array_equal(jbow.make_codebook(256, path=path), vocab)
    np.testing.assert_array_equal(tbow.make_codebook(256, seed=11),
                                  jbow.make_codebook(256, seed=11))
    with pytest.raises(AssertionError):
        tbow.make_codebook(128, path=path)


@pytest.mark.parametrize("n", [600, 1000])
def test_quantize_device_branch_words_equal(n):
    """Above the threshold the port runs ``hamming_argmin`` (its plain
    version on CPU tensors), the reference ``argmin(hamming_matrix)``."""
    jbow = importlib.import_module("slam_tpu.ops.bow")
    rng = np.random.default_rng(n)
    cb = _tied_vocabulary()
    desc = _near_copies(rng, cb, n, flips=40)
    desc[:16] = cb[:16]                      # exact hits on the tied rows
    desc[16] = cb[7]
    before = tbow.quantize.device_calls
    got = tbow.quantize(desc, cb, "cpu")
    assert tbow.quantize.device_calls == before + 1
    want = jbow.quantize(desc, cb)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:17], list(range(16)) + [7])


def test_quantize_host_branch_words_equal():
    jbow = importlib.import_module("slam_tpu.ops.bow")
    rng = np.random.default_rng(5)
    cb = _tied_vocabulary()
    desc = _near_copies(rng, cb, 40, flips=30)
    before = tbow.quantize.device_calls
    got = tbow.quantize(desc, cb, "cpu")
    assert tbow.quantize.device_calls == before      # native host scan
    np.testing.assert_array_equal(got, jbow.quantize(desc, cb))
    assert len(tbow.quantize(desc[:0], cb, "cpu")) == 0


def test_bow_index_equals_the_reference():
    """transform -> add -> get_bow_similar on both packages' indexes."""
    jbow = importlib.import_module("slam_tpu.ops.bow")
    jids = importlib.import_module("slam_tpu.ids")
    from slam_tpu_torch import ids as tids

    class _Shared:
        def __init__(self, desc):
            self.descriptors, self.words = desc, None

    class _Kf:
        def __init__(self, i, desc):
            self.id, self.shared = i, _Shared(desc)

    p = ParametersSlam(bowVocabularySize=1024, bowFeatureGroups=64)
    jp = importlib.import_module("slam_tpu.params").ParametersSlam(
        bowVocabularySize=1024, bowFeatureGroups=64)
    ti, ji = tbow.BowIndex(p, device="cpu"), jbow.BowIndex(jp)
    np.testing.assert_array_equal(ti.codebook, ji.codebook)
    rng = np.random.default_rng(6)
    base = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    kfs = [(_Kf(tids.KfId(i), _near_copies(rng, base, 300, 12)), None)
           for i in range(6)]
    kfs = [(t, _Kf(jids.KfId(int(t.id)), t.shared.descriptors.copy()))
           for t, _ in kfs]
    for t, j in kfs:
        ti.transform(t.shared)
        ji.transform(j.shared)
        np.testing.assert_array_equal(t.shared.words, j.shared.words)
        np.testing.assert_array_equal(t.shared.groups, j.shared.groups)
        ti.add(t, tids.CURRENT_MAP_ID)
        ji.add(j, jids.CURRENT_MAP_ID)
    got = ti.get_bow_similar(None, [], kfs[2][0])
    want = ji.get_bow_similar(None, [], kfs[2][1])
    assert [(int(s.map_kf.kf_id), s.score) for s in got] == \
        [(int(s.map_kf.kf_id), s.score) for s in want]
    assert len(got) >= 1


@pytest.mark.cuda
def test_quantize_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from slam_tpu_torch.ops.hamming_argmin import hamming_argmin

    rng = np.random.default_rng(8)
    cb = _tied_vocabulary()
    desc = _near_copies(rng, cb, 856, flips=40)
    desc[:16] = cb[:16]
    before = hamming_argmin.launches
    got = tbow.quantize(desc, cb, "cuda")
    assert hamming_argmin.launches == before + 1
    np.testing.assert_array_equal(got, tbow.quantize(desc, cb, "cpu"))
