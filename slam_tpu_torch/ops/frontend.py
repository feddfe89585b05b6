"""ORB front-end: pyramid + detection + orientation + descriptors (port of
slam_tpu/ops/frontend.py).

``extract`` runs a batch of S frames into fixed-layout padded tensors. Slot
layout along the keypoint axis:

    [0, n_tracked)                        tracked-keypoint slots
    [n_tracked + sum(budgets[:l]), ...)   level-l detected slots

with a validity mask; invalid slots hold deterministic filler and must be
ignored. ``OrbExtractor`` is the interactive path's per-frame front-end
(reference: ``OrbExtractor::detectAndExtract``, orb_extractor.cpp:73-164):
one extraction on its device, then the BoW words of every slot against
the vocabulary held on that device (``ops/hamming_argmin``, the
hand-written CUDA kernel on the card), and one copy of the outputs into
pinned host memory behind the work. Its extraction goes through
:data:`EXTRACT_GRAPHS`, one CUDA graph per geometry on a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from slam_tpu_torch.ops import detector as det
from slam_tpu_torch.ops import orb
from slam_tpu_torch.ops.graphs import GraphCache, where
from slam_tpu_torch.ops.pyramid import (build_pyramid, device_operators,
                                        level_sizes, quantise)
from slam_tpu_torch.params import ORB_PATCH_RADIUS, StaticSettings
from slam_tpu_torch.precision import pin_full_f32
from slam_tpu_torch.utils import timer
from slam_tpu_torch.utils.timer import timed, timed_as


class FrontendSpec(NamedTuple):
    """Static extraction settings (the JAX package's ``spec`` tuple)."""
    scale_factors: Tuple[float, ...]
    budgets: Tuple[int, ...]
    min_dists: Tuple[int, ...]
    lk_level: int
    use_fast: bool
    width: int
    height: int


class Features(NamedTuple):
    pts: torch.Tensor       # (S, N, 2) float32, full-resolution pixels
    octave: torch.Tensor    # (S, N) int32 pyramid level
    angle: torch.Tensor     # (S, N) float32 degrees
    desc: torch.Tensor      # (S, N, 8) int32 descriptor bit patterns
    valid: torch.Tensor     # (S, N) bool


def min_distances(settings: StaticSettings, sizes) -> List[int]:
    """Per-level GFTT min distance (reference: feature_detector.cpp:79-82)."""
    out = []
    for (w, h) in sizes:
        su = min(w, h) / 720.0 * 0.8
        out.append(int(np.floor(settings.parameters.slam.gfttMinDistance
                                * su + 0.5)))
    return out


def _operators(spec: FrontendSpec, device: torch.device):
    """Band matrices of one geometry, moved to ``device`` once."""
    return device_operators(spec.width, spec.height, spec.scale_factors,
                            device)


def extract(image: torch.Tensor, tracked_xy: torch.Tensor,
            tracked_valid: torch.Tensor, spec: FrontendSpec) -> Features:
    """(S, H, W) images, (S, T, 2) tracked points, (S, T) validity ->
    :class:`Features` with N = T + sum(budgets) slots per frame. On a card
    the caller pins full f32 first (``slam_tpu_torch/precision.py``)."""
    sizes, resize_ops, blur_ops = _operators(spec, image.device)
    levels, blurred = build_pyramid(image.to(torch.float32), resize_ops,
                                    blur_ops)
    return extract_from_pyramid(levels, blurred, sizes, tracked_xy,
                                tracked_valid, spec)


def extract_from_pyramid(levels, blurred, sizes, tracked_xy: torch.Tensor,
                         tracked_valid: torch.Tensor, spec: FrontendSpec
                         ) -> Features:
    """Detection, orientation and descriptors on a built pyramid (lists of
    (S, H_l, W_l) level and blurred-level images): every level's keypoints
    are taken first, then one :func:`orb.orb_features` call describes the
    tracked and the detected slots together."""
    S = levels[0].shape[0]
    dev = levels[0].device
    out_pts, out_oct, out_valid = [], [], []

    # tracked keypoints at the fixed LK level
    lk = spec.lk_level
    lk_scale = float(np.float32(spec.scale_factors[lk]))
    lk_w, lk_h = sizes[lk]
    xi = torch.round(tracked_xy[..., 0] / lk_scale)
    yi = torch.round(tracked_xy[..., 1] / lk_scale)
    margin = ORB_PATCH_RADIUS
    t_ok = (tracked_valid & (xi >= margin) & (yi >= margin)
            & (xi < lk_w - margin) & (yi < lk_h - margin))
    groups = [(levels[lk], blurred[lk], torch.stack([xi, yi], dim=-1))]
    out_pts.append(tracked_xy)
    out_oct.append(torch.full(t_ok.shape, lk, dtype=torch.int32, device=dev))
    out_valid.append(t_ok)

    # detected keypoints per level; GFTT detects on every level at once
    lvls = [lvl for lvl, budget in enumerate(spec.budgets) if budget > 0]
    mds = [spec.min_dists[lvl] for lvl in lvls]
    if spec.use_fast:
        maps = [det.peak_map(det.fast_response(quantise(levels[lvl])), md)
                for lvl, md in zip(lvls, mds)]
    else:
        maps = det.gftt_peaks([levels[lvl] for lvl in lvls], mds)
    for lvl, masked in zip(lvls, maps):
        budget = spec.budgets[lvl]
        xy, _, valid = det.take_best(masked, budget)
        groups.append((levels[lvl], blurred[lvl], xy))
        out_pts.append(xy * float(np.float32(spec.scale_factors[lvl])))
        out_oct.append(torch.full((S, budget), lvl, dtype=torch.int32,
                                  device=dev))
        out_valid.append(valid)

    angle, desc = orb.orb_features(groups)
    return Features(torch.cat(out_pts, 1), torch.cat(out_oct, 1), angle,
                    desc, torch.cat(out_valid, 1))


def _extract_frame(image: torch.Tensor, tracked_xy: torch.Tensor,
                   tracked_valid: torch.Tensor, spec: FrontendSpec) -> tuple:
    """:func:`extract` of one (H, W) uint8 image with (T, 2) tracked points
    and (T,) validity: (pts, octave, angle, desc, valid), desc contiguous."""
    f = extract(image[None], tracked_xy[None], tracked_valid[None], spec)
    return (f.pts[0], f.octave[0], f.angle[0], f.desc[0].contiguous(),
            f.valid[0])


def _before_capture(key: tuple):
    """Before an extraction graph's capture: TF32 off (it would choose
    other cuBLAS kernels for the pyramid's band matmuls), and the
    geometry's band matrices, which the graph reads by address, for its
    entry to hold."""
    pin_full_f32()
    device, _, spec, _ = key
    return _operators(spec, device)


# one program per extraction geometry, process-wide; its facts are in
# ops/graphs' table
EXTRACT_GRAPHS = GraphCache("extract", pool="entry", lock="entry",
                            capture_error_mode="thread_local", warm_up=True,
                            before_capture=_before_capture)


@contextlib.contextmanager
def extraction(spec: FrontendSpec, image: torch.Tensor,
               tracked_xy: torch.Tensor, tracked_valid: torch.Tensor,
               device):
    """Yield (pts, octave, angle, desc, valid) on ``device`` for an (H, W)
    uint8 ``image`` and (T, 2) / (T,) tracked points, which may lie on the
    host (pinned, for an asynchronous copy), through
    :data:`EXTRACT_GRAPHS`.

    An entry is the device, the caller's current stream, the
    :class:`FrontendSpec` and the number of slots; every extractor of that
    geometry shares it. Its first call runs :func:`extract` on the
    caller's tensors. Every later call copies the image and the tracked
    points into the entry's fixed buffers and, on a card, replays the
    entry's CUDA graph on the caller's current stream (the second call
    captures it first); on the CPU the later calls run :func:`extract`
    eagerly on the same buffers. The outputs come with the entry's lock
    held: on a card they are the graph's own tensors, so the caller
    enqueues what reads them (the words, the copy out) inside the
    ``with``, on the same stream, before the next call of the entry can
    replay it."""
    device, _, stream = where(device)
    slots = tracked_xy.shape[0] + sum(spec.budgets)
    e, first = EXTRACT_GRAPHS.entry(
        (device, stream, spec, slots),
        dict(width=spec.width, height=spec.height, slots=slots))
    host = (image, tracked_xy, tracked_valid)
    with EXTRACT_GRAPHS.hold(e, device):
        with timer.section("extract.extract"):
            if first:
                out = EXTRACT_GRAPHS.eager(
                    _extract_frame, *(t.to(device, non_blocking=True)
                                      for t in host), spec)
            else:
                EXTRACT_GRAPHS.copy_in(e, host, device)
                out = EXTRACT_GRAPHS.run(
                    e, lambda: _extract_frame(*e.inputs, spec), device)
        yield out


@dataclasses.dataclass
class FrontendResult:
    """Padded per-frame features (NumPy, on host)."""
    pts: np.ndarray        # (N, 2) float32, full-resolution pixel coords
    octave: np.ndarray     # (N,) int32 pyramid level
    angle: np.ndarray      # (N,) float32 degrees
    descriptors: np.ndarray  # (N, 8) uint32
    valid: np.ndarray      # (N,) bool
    track_ids: np.ndarray  # (N,) int32, -1 for detected (non-tracked) slots
    words: Optional[np.ndarray] = None  # (N,) int32 BoW word ids

    def compact(self) -> "FrontendResult":
        """Drop invalid slots."""
        v = self.valid
        return FrontendResult(self.pts[v], self.octave[v], self.angle[v],
                              self.descriptors[v], np.ones(int(v.sum()), bool),
                              self.track_ids[v],
                              None if self.words is None else self.words[v])


class _Pending(NamedTuple):
    outputs: Tuple[torch.Tensor, ...]   # host tensors (pinned on a card)
    event: Optional[torch.cuda.Event]   # recorded behind their copy
    track_ids: np.ndarray


class OrbExtractor:
    """Per-geometry front-end on one device (reference:
    orb_extractor.hpp:16-20). ``device`` defaults to the card; CPU callers
    pass ``device="cpu"``."""

    def __init__(self, settings: StaticSettings, width: int, height: int,
                 max_tracked: int = 256, device="cuda"):
        p = settings.parameters.slam
        self.settings = settings
        self.width = width
        self.height = height
        self.max_tracked = max_tracked
        self.device = torch.device(device)
        scale_factors = tuple(float(s) for s in settings.scaleFactors)
        self.sizes = level_sizes(width, height, scale_factors)
        budgets = tuple(settings.maxNumberOfKeypointsPerLevel())
        self._spec = FrontendSpec(scale_factors, budgets,
                                  tuple(min_distances(settings, self.sizes)),
                                  int(p.orbLkTrackLevel),
                                  p.slamFeatureDetector.lower() == "fast",
                                  width, height)
        self.vocab_size = int(getattr(p, "bowVocabularySize", 0))
        self.vocab_path = str(getattr(p, "vocabularyPath", ""))
        self.num_slots = max_tracked + sum(budgets)
        self.extractions = 0          # device extractions enqueued
        self._codebook = None
        self._pending = {}

    def _pack_tracked(self, tracked_xy, track_ids):
        kt = self.max_tracked
        txy = np.zeros((kt, 2), np.float32)
        tvalid = np.zeros((kt,), bool)
        tids = np.full((self.num_slots,), -1, np.int32)
        if tracked_xy is not None and len(tracked_xy) > 0:
            k = min(len(tracked_xy), kt)
            txy[:k] = np.asarray(tracked_xy, np.float32)[:k]
            tvalid[:k] = True
            if track_ids is not None:
                tids[:k] = np.asarray(track_ids, np.int32)[:k]
        return txy, tvalid, tids

    def _vocabulary(self) -> torch.Tensor:
        if self._codebook is None:
            from slam_tpu_torch.ops.bow import device_codebook, make_codebook
            self._codebook = device_codebook(
                make_codebook(self.vocab_size, path=self.vocab_path),
                self.device)
        return self._codebook

    @timed_as("extract.enqueue")
    def _enqueue(self, image, tracked_xy, track_ids) -> _Pending:
        """Issue the extraction (:data:`EXTRACT_GRAPHS`), the words and the
        host copy on the current stream of the device; returns without
        waiting for the device."""
        from slam_tpu_torch.ops.hamming_argmin import hamming_argmin

        pin_full_f32()
        on_card = self.device.type == "cuda"
        with timer.section("extract.pack"):
            txy, tvalid, tids = self._pack_tracked(tracked_xy, track_ids)
        with timer.section("extract.upload"):
            host = tuple(torch.from_numpy(a) for a in
                         (np.ascontiguousarray(image, np.uint8), txy, tvalid))
            if on_card:
                host = tuple(t.pin_memory() for t in host)
        with extraction(self._spec, *host, self.device) as found:
            pts, octave, angle, desc, valid = found
            with timer.section("extract.words"):
                if self.vocab_size > 0:
                    _, words = hamming_argmin(desc, self._vocabulary())
                else:
                    words = torch.zeros(desc.shape[:1], dtype=torch.int32,
                                        device=self.device)
            self.extractions += 1
            timer.count("extract.extraction")
            outputs = (pts, octave, angle, desc, valid, words)
            if not on_card:
                return _Pending(outputs, None, tids)
            # behind the replay on the same stream: the next replay of the
            # geometry overwrites the outputs only after they are copied
            with timer.section("extract.copy_out"):
                out = tuple(torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True) for t in outputs)
                for h, t in zip(out, outputs):
                    h.copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        return _Pending(out, event, tids)

    def prefetch(self, key, image: np.ndarray,
                 tracked_xy: Optional[np.ndarray] = None,
                 track_ids: Optional[np.ndarray] = None) -> None:
        """Enqueue extraction for a future frame without waiting: the device
        work and its host copy overlap the host pipeline of the current
        frame. ``detect_and_extract(..., key=...)`` collects it."""
        self._pending[key] = self._enqueue(image, tracked_xy, track_ids)

    @timed
    def detect_and_extract(self, image: np.ndarray,
                           tracked_xy: Optional[np.ndarray] = None,
                           track_ids: Optional[np.ndarray] = None,
                           key=None) -> FrontendResult:
        """Run the front-end for one frame (or collect a prefetch).

        ``tracked_xy``: (K, 2) full-res positions of LK-tracked features,
        ``track_ids``: (K,) their odometry track ids. K <= max_tracked.
        Waits only on the event behind this frame's host copy."""
        pending = self._pending.pop(key, None) if key is not None else None
        if pending is None:
            pending = self._enqueue(image, tracked_xy, track_ids)
        if pending.event is not None:
            with timer.section("extract.wait"):
                pending.event.synchronize()
        pts, octv, ang, desc, valid, words = (t.numpy()
                                              for t in pending.outputs)
        return FrontendResult(pts.copy(), octv.copy(), ang.copy(),
                              desc.view(np.uint32).copy(), valid.copy(),
                              pending.track_ids, words.copy())
