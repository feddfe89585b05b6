"""Place recognition: descriptor quantization and the BoW inverted index
(port of slam_tpu/ops/bow.py).

The reference uses a DBoW2 ORB vocabulary tree (~10^6 words, 6 levels, k=10)
loaded from disk, an inverted index, and L1 BoW scoring (reference:
bow_index.cpp). Here:

  - a codebook of V 256-bit centroids: the trained vocabulary
    ``slam_tpu_torch/data/vocab_<V>.npz`` or an explicit ``.npz``, else
    seeded random bits (an LSH-style quantizer);
  - quantization of all keypoint descriptors against the whole codebook:
    native host popcount for small problems, and above the reference's
    threshold the nearest-codeword kernel ``ops/hamming_argmin`` (the
    hand-written CUDA kernel on the card) with the same first-minimum ties;
  - per-keyframe retrieval signature = L2-normalized word histogram; keyframe
    similarity = signature dot product over an inverted index.

The DBoW2 ``FeatureVector`` (node buckets at levelsUp=4, ~100 groups,
bow_index.cpp:82-92) maps to ``groups`` = the top bits of the word id.
``get_bow_similar`` reproduces the reference's candidate selection contract
(bow_index.cpp:95-176).
"""
from __future__ import annotations

import functools
import os
import threading
from itertools import chain
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ids import MapId, CURRENT_MAP_ID
from slam_tpu_torch.map.mapdb import MapDB, MapKf
from slam_tpu_torch.params import ParametersSlam
from slam_tpu_torch.utils.timer import timed

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
_CODEBOOK_SEED = 94235682  # deterministic, nod to random_array.cc:21


class BowSimilar(NamedTuple):
    """reference: bow_index.hpp:31-34"""
    map_kf: MapKf
    score: float


@functools.lru_cache(maxsize=4)
def make_codebook(num_words: int, seed: int = _CODEBOOK_SEED,
                  path: str = "") -> np.ndarray:
    """(V, 8) uint32 binary centroids.

    ``path`` (the reference's ``vocabularyPath`` knob, loaded at
    bow_index.cpp:12-28) names an explicit ``.npz`` with a ``codebook``
    array of exactly ``num_words`` 256-bit rows. When empty, loads the
    package's trained vocabulary ``data/vocab_<V>.npz`` when it exists and
    ``seed`` is the default; otherwise returns seeded random centroids."""
    if not path:
        default = os.path.join(DATA_DIR, f"vocab_{num_words}.npz")
        if seed == _CODEBOOK_SEED and os.path.exists(default):
            path = default
    if path:
        vocab = np.load(path)["codebook"]
        assert vocab.shape == (num_words, 8) and vocab.dtype == np.uint32, (
            f"vocabulary at {path}: expected ({num_words}, 8) uint32, got "
            f"{vocab.shape} {vocab.dtype} — set bowVocabularySize to match")
        return vocab
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(num_words, 8), dtype=np.uint32)


def device_codebook(codebook: np.ndarray, device) -> torch.Tensor:
    """(V, 8) uint32 codebook -> contiguous (V, 8) int32 bit-view tensor on
    ``device``, the layout ``ops/hamming_argmin`` takes."""
    return torch.from_numpy(np.ascontiguousarray(codebook, np.uint32)
                            .view(np.int32)).to(device)


# concurrent sessions (parallel/batch.py) quantize from several threads
_COUNT_LOCK = threading.Lock()


def quantize(descriptors: np.ndarray, codebook: np.ndarray, device,
             codebook_dev: torch.Tensor = None) -> np.ndarray:
    """Nearest-centroid word ids (first minimum on ties) of (N, 8) uint32
    descriptors. Below the reference's size threshold the native host scan
    runs; above it, the nearest-codeword kernel on ``device`` (one launch,
    counted in ``quantize.device_calls``). ``codebook_dev``: the codebook
    already on ``device`` (:func:`device_codebook`)."""
    n = len(descriptors)
    if n == 0:
        return np.zeros(0, np.int32)
    from slam_tpu_torch import native
    threshold = (1 << 23) if native.available() else (1 << 18)
    if n * len(codebook) >= threshold:
        from slam_tpu_torch.ops.hamming_argmin import hamming_argmin
        if codebook_dev is None:
            codebook_dev = device_codebook(codebook, device)
        d = torch.from_numpy(np.ascontiguousarray(descriptors, np.uint32)
                             .view(np.int32)).to(device)
        _, idx = hamming_argmin(d, codebook_dev)
        with _COUNT_LOCK:
            quantize.device_calls += 1
        return idx.cpu().numpy()
    words = native.hamming_argmin(descriptors, codebook)
    if words is not None:
        return words
    dist = native.hamming_matrix(descriptors, codebook)
    return np.argmin(dist, axis=1).astype(np.int32)


quantize.device_calls = 0


class BowIndex:
    """reference: bow_index.{hpp,cpp}

    The retrieval store is an inverted index word -> postings, exactly like
    the reference's ``index[wordId].push_back(mapKf)`` (bow_index.cpp:44-48):
    queries touch only the postings of the query's words, and ``remove`` is
    an O(1) tombstone. Each posting carries the entry's normalized signature
    weight for that word, so the accumulated score is the dense signature
    dot product. ``device`` is where quantization above the size threshold
    runs; the codebook is copied there once."""

    def __init__(self, parameters: ParametersSlam, device="cuda"):
        self.parameters = parameters
        self.device = torch.device(device)
        self.num_words = parameters.bowVocabularySize
        self.num_groups = parameters.bowFeatureGroups
        assert self.num_words % self.num_groups == 0
        self._group_div = self.num_words // self.num_groups
        self.codebook = make_codebook(self.num_words,
                                      path=parameters.vocabularyPath)
        self._codebook_dev = None
        # inverted index: word -> (entry rows, per-row signature weights)
        self._post_rows: Dict[int, List[int]] = {}
        self._post_weights: Dict[int, List[float]] = {}
        self._entries: List[MapKf] = []       # row id -> MapKf (tombstoned)
        self._alive: List[bool] = []
        self._row_of: Dict[MapKf, int] = {}
        self._n_alive = 0

    # ------------------------------------------------------------------

    def quantize(self, descriptors: np.ndarray) -> np.ndarray:
        if self._codebook_dev is None:
            self._codebook_dev = device_codebook(self.codebook, self.device)
        return quantize(descriptors, self.codebook, self.device,
                        self._codebook_dev)

    @timed
    def transform(self, shared) -> None:
        """Fill words/groups/signature of a KeyframeShared
        (equivalent of BowIndex::transform, bow_index.cpp:59-93). Reuses
        words already quantized on the device by the fused front-end
        (identical integer distances + first-min tie-breaking) when
        present."""
        n = len(shared.descriptors)
        if (shared.words is not None and len(shared.words) == n and n > 0):
            words = np.asarray(shared.words, np.int32)
        else:
            words = self.quantize(shared.descriptors)
        shared.words = words
        shared.groups = (words // self._group_div).astype(np.int32)
        # sparse signature (unique words, L2-normalized weights): every
        # consumer only reads the entry's own words
        uw, cnt = np.unique(words, return_counts=True)
        cnt = cnt.astype(np.float32)
        n = float(np.linalg.norm(cnt))
        shared.bow_signature = (uw.astype(np.int32),
                                cnt / n if n > 0 else cnt)

    # ------------------------------------------------------------------

    def add(self, keyframe, map_id: MapId) -> None:
        assert keyframe.shared.bow_signature is not None, "transform() first"
        map_kf = MapKf(map_id, keyframe.id)
        # re-registration must not leak the previous row: it would stay
        # alive in every postings list forever (remove only tombstones the
        # newest row for a given MapKf)
        if map_kf in self._row_of:
            self.remove(map_kf)
        row = len(self._entries)
        self._entries.append(map_kf)
        self._alive.append(True)
        self._row_of[map_kf] = row
        self._n_alive += 1
        uw, wt = keyframe.shared.bow_signature
        for w, weight in zip(uw.tolist(), wt.tolist()):
            self._post_rows.setdefault(w, []).append(row)
            self._post_weights.setdefault(w, []).append(weight)

    def remove(self, map_kf: MapKf) -> None:
        row = self._row_of.pop(map_kf, None)
        if row is None:
            return
        self._alive[row] = False
        self._n_alive -= 1
        # amortized cleanup: when most rows are dead, rebuild the postings
        if (len(self._entries) > 64
                and self._n_alive < len(self._entries) // 2):
            self._compact()

    def _compact(self) -> None:
        remap = {}
        entries, alive = [], []
        for row, (e, a) in enumerate(zip(self._entries, self._alive)):
            if a:
                remap[row] = len(entries)
                entries.append(e)
                alive.append(True)
        for w in list(self._post_rows):
            rows = self._post_rows[w]
            weights = self._post_weights[w]
            kept = [(remap[r], wt) for r, wt in zip(rows, weights) if r in remap]
            if kept:
                self._post_rows[w] = [r for r, _ in kept]
                self._post_weights[w] = [wt for _, wt in kept]
            else:
                del self._post_rows[w]
                del self._post_weights[w]
        self._entries = entries
        self._alive = alive
        self._row_of = {e: i for i, e in enumerate(entries)}

    def __len__(self) -> int:
        return self._n_alive

    @staticmethod
    def score(a_shared, b_shared) -> float:
        """Cosine similarity of two keyframes' sparse BoW signatures (the
        quantity get_bow_similar accumulates per candidate)."""
        aw, av = a_shared.bow_signature
        bw, bv = b_shared.bow_signature
        ia = {int(w): float(v) for w, v in zip(aw.tolist(), av.tolist())}
        return float(sum(ia.get(int(w), 0.0) * float(v)
                         for w, v in zip(bw.tolist(), bv.tolist())))

    # ------------------------------------------------------------------

    @timed
    def get_bow_similar(self, map_db: MapDB, atlas, kf) -> List[BowSimilar]:
        """Candidate keyframes for loop closure / relocation
        (reference: bow_index.cpp:95-176). One pass over the postings of the
        query's words accumulates both words-in-common counts and signature
        dot products; gating then follows the reference contract exactly
        (strict > on the in-common ratio, >= on the score ratio)."""
        if self._n_alive == 0:
            return []
        current = MapKf(CURRENT_MAP_ID, kf.id)
        q_words, q_wt = kf.shared.bow_signature

        n_rows = len(self._entries)
        rows_lists, weight_lists, q_factors, lens = [], [], [], []
        for w, qv in zip(q_words.tolist(), q_wt.tolist()):
            rows = self._post_rows.get(w)
            if not rows:
                continue
            rows_lists.append(rows)
            weight_lists.append(self._post_weights[w])
            q_factors.append(float(qv))
            lens.append(len(rows))
        if not rows_lists:
            return []
        total = sum(lens)
        cat_rows = np.fromiter(chain.from_iterable(rows_lists), np.int64, total)
        cat_w = np.fromiter(chain.from_iterable(weight_lists), np.float64, total)
        qf = np.repeat(np.asarray(q_factors), lens)
        counts = np.bincount(cat_rows, minlength=n_rows)
        scores = np.bincount(cat_rows, weights=qf * cat_w, minlength=n_rows)

        live = np.asarray(self._alive, bool)
        cur_row = self._row_of.get(current)
        if cur_row is not None:
            live = live.copy()
            live[cur_row] = False
        counts = np.where(live, counts, 0)

        max_in_common = int(counts.max()) if n_rows else 0
        if max_in_common == 0:
            return []
        min_in_common = int(self.parameters.bowMinInCommonRatio * max_in_common)

        cand = np.flatnonzero(counts > min_in_common)
        similar = [BowSimilar(self._entries[i], float(scores[i])) for i in cand]
        if not similar:
            return []
        similar.sort(key=lambda x: -x.score)
        min_score = similar[0].score * self.parameters.bowScoreRatio
        return [s for s in similar if s.score >= min_score]
