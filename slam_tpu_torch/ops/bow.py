"""Retrieval codebook (port of ``make_codebook`` from slam_tpu/ops/bow.py;
the rest of that module stays with the host map layer)."""
from __future__ import annotations

import functools
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


@functools.lru_cache(maxsize=4)
def make_codebook(num_words: int) -> np.ndarray:
    """(V, 8) uint32 binary centroids: the port's copy of the trained
    vocabulary, ``slam_tpu_torch/data/vocab_<V>.npz``. Raises when that
    file is absent."""
    path = os.path.join(DATA_DIR, f"vocab_{num_words}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trained vocabulary of {num_words} words "
                                f"at {path}")
    vocab = np.load(path)["codebook"]
    assert vocab.shape == (num_words, 8) and vocab.dtype == np.uint32, (
        f"vocabulary at {path}: expected ({num_words}, 8) uint32, got "
        f"{vocab.shape} {vocab.dtype}")
    return vocab
