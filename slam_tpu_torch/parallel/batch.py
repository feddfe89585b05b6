"""Offline multi-sequence mapping: concurrent SLAM sessions on one card.

A serving-style capability beyond the reference's single-session design:
N independent sequences are mapped concurrently, each with its own Mapper
(host state is per-session; nothing is shared). Device dispatches from all
sessions interleave on the accelerator, overlapping one session's host-side
map bookkeeping with another's kernels — the one-card analogue of the
`data` mesh axis in `parallel/multichip.py` (which covers the multi-device
case where each shard processes different frames). Every session runs its
device work on the device given to ``map_sequences`` (the card unless the
caller passes ``device="cpu"``).
"""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Callable, Iterable, List, Optional, Sequence

from slam_tpu_torch.map.keyframe import MapperInput
from slam_tpu_torch.params import Parameters
from slam_tpu_torch.pipeline.mapper import Mapper


def map_sequences(sequences: Sequence[Iterable[MapperInput]],
                  parameters: Parameters,
                  orb_extractor_factory: Optional[Callable[[], object]] = None,
                  n_workers: Optional[int] = None,
                  end_save_paths: Optional[Sequence[str]] = None,
                  device="cuda") -> List[Mapper]:
    """Run one full SLAM session per input sequence, concurrently.

    ``sequences``: per-sequence iterables of MapperInput.
    ``orb_extractor_factory``: optional per-session front-end factory (e.g.
    a different camera geometry per sequence, or a test stub).
    Returns the finished Mapper per sequence (maps audited by ``end()``).
    """
    n = len(sequences)
    n_workers = n_workers or min(n, 8)
    mappers: List[Optional[Mapper]] = [None] * n

    takes_index = (orb_extractor_factory is not None
                   and _wants_index(orb_extractor_factory))

    def run(idx: int) -> None:
        if orb_extractor_factory is None:
            extractor = None
        elif takes_index:  # factory may be sequence-dependent
            extractor = orb_extractor_factory(idx)
        else:
            extractor = orb_extractor_factory()
        mapper = Mapper(parameters, orb_extractor=extractor,
                        device=device)
        for mapper_input in sequences[idx]:
            mapper.advance(mapper_input)
        save = end_save_paths[idx] if end_save_paths else ""
        mapper.end(save)
        mappers[idx] = mapper

    with concurrent.futures.ThreadPoolExecutor(max_workers=n_workers) as pool:
        futures = [pool.submit(run, i) for i in range(n)]
        for f in futures:
            f.result()  # re-raise worker exceptions
    return [m for m in mappers if m is not None]


def _wants_index(factory) -> bool:
    import inspect
    try:
        sig = inspect.signature(factory)
        return len(sig.parameters) >= 1
    except (TypeError, ValueError):
        return False
