"""Mapper orchestration: frontend/backend split, work queue, map snapshots.

Rebuild of the reference mapper (reference: mapper.cpp):

  - backend-only mode (``useFrontendSlam=false``, mapper.cpp:406-434): every
    frame runs the full backend pipeline synchronously;
  - dual-map mode (mapper.cpp:118-404): a low-latency frontend handles every
    frame against a periodically refreshed snapshot of the backend map while
    a backend thread runs full mapping, lagging ``backendProcessDelay``
    frames so it can splice refined pose trails from queued future frames
    (mapper.cpp:239-266); the deterministic map-copy handshake
    (requestMapCopy/waitMapCopyRequest/..., mapper.cpp:199-227) is
    reproduced with condition variables for bit-reproducible runs.

All device work runs on the device given at construction (``"cuda"`` unless
the caller asks for ``"cpu"``): the ORB extractor, BoW quantization, bundle
adjustment and loop closure. CUDA launches are asynchronous, so device work
from the backend overlaps the frontend's host bookkeeping; every thread
issues its work on the device's current stream and waits only on events
recorded there behind its own host copies.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_tpu_torch.geometry import se3
from slam_tpu_torch.ids import KfId, MapId, MpId
from slam_tpu_torch.map.keyframe import Keyframe, MapperInput
from slam_tpu_torch.map.mapdb import Atlas, MapDB
from slam_tpu_torch.ops.bow import BowIndex
from slam_tpu_torch.ops.frontend import OrbExtractor
from slam_tpu_torch.params import Parameters, StaticSettings
from slam_tpu_torch.pipeline.adjacency import compute_adjacent_keyframes
from slam_tpu_torch.pipeline.bundle_adjustment import WorkspaceBA
from slam_tpu_torch.pipeline.loop_closer import LoopCloser
from slam_tpu_torch.pipeline.mapper_helpers import (add_keyframe_backend,
                                                    add_keyframe_frontend,
                                                    check_consistency,
                                                    finalize_pending_ba,
                                                    make_keyframe_decision)
from slam_tpu_torch.precision import pin_full_f32
from slam_tpu_torch.utils.stats import BaStats
from slam_tpu_torch.utils.timer import timed_as
from slam_tpu_torch.map.serialization import load_map_db, save_map_db, save_trajectory_csv


@dataclasses.dataclass
class InputFrame:
    """reference: mapper.cpp:49-53"""
    keyframe: Keyframe
    keyframe_decision: bool
    mapper_input: MapperInput


class WorkQueue:
    """Blocking bounded queue with dequeue delay (reference: mapper.cpp:55-116)."""

    def __init__(self, max_size: int, delay: int):
        self._max_size = max_size
        self._delay = delay
        self._items: List[Optional[InputFrame]] = []
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)

    def push(self, item: Optional[InputFrame]) -> None:
        with self._not_full:
            while len(self._items) >= self._max_size:
                self._not_full.wait()
            self._items.append(item)
            self._not_empty.notify()

    def wait_and_dequeue(self) -> Optional[InputFrame]:
        with self._not_empty:
            while len(self._items) <= self._delay:
                self._not_empty.wait()
            item = self._items.pop(0)
            self._not_full.notify()
            return item

    def all(self) -> List[Optional[InputFrame]]:
        with self._lock:
            return list(self._items)

    def task(self, index: int) -> Optional[InputFrame]:
        with self._lock:
            if 0 <= index < len(self._items):
                return self._items[index]
            return None

    def set_delay(self, delay: int) -> None:
        with self._lock:
            self._delay = delay
            self._not_empty.notify()


class Mapper:
    """reference: mapper.cpp:118-555 (MapperImplementation). ``device``:
    where its device work runs."""

    def __init__(self, parameters: Parameters,
                 image_size: Optional[Tuple[int, int]] = None,
                 orb_extractor=None, device="cuda"):
        self.settings = StaticSettings(parameters)
        self.device = torch.device(device)
        pin_full_f32()
        p = parameters.slam
        self.map_db = MapDB()
        self.frontend_map_db = MapDB()
        self.atlas: Atlas = []
        self.bow_index = BowIndex(p, device=self.device)
        self.loop_closer = LoopCloser(self.settings, self.bow_index,
                                      self.map_db, self.atlas,
                                      device=self.device)
        self.workspace_ba = WorkspaceBA(ba_stats=BaStats(p.printBaStats),
                                        device=self.device)
        self.viewer_publisher = None
        self.end_debug_callback: Optional[Callable] = None

        self._orb_extractor = orb_extractor
        self._image_size = image_size

        self._frontend_frame_counter = 0
        self._backend_frame_counter = 0
        self._should_quit = False
        self._frontend_map_mutex = threading.Lock()
        self._map_copy_requested = False
        self._map_copy_cond = threading.Condition()
        self.backend_queue = WorkQueue(
            max(10, int(p.backendProcessDelay)
                + int(p.copySlamMapEveryNSlamFrames) * 2 + 2),
            p.backendProcessDelay)
        self._thread: Optional[threading.Thread] = None
        if p.useFrontendSlam:
            self._thread = threading.Thread(target=self._work, daemon=True)
            self._thread.start()

        # atlas loading (mapper.cpp:171-177)
        for map_ind, load_path in enumerate(p.mapdbLoadPath):
            if not load_path:
                continue
            self.atlas.append(load_map_db(MapId(map_ind), self.bow_index,
                                          load_path))

    # ------------------------------------------------------------------

    def _get_orb_extractor(self, mapper_input: MapperInput):
        if self._orb_extractor is None:
            frame = mapper_input.frame
            assert frame is not None, "need an image or an injected extractor"
            h, w = frame.shape
            self._orb_extractor = OrbExtractor(self.settings, w, h,
                                               device=self.device)
        return self._orb_extractor

    # ------------------------------------------------------------------
    # deterministic map-copy handshake (reference: mapper.cpp:199-227)
    # ------------------------------------------------------------------

    def _request_map_copy(self):
        with self._map_copy_cond:
            self._map_copy_requested = True
            self._map_copy_cond.notify_all()

    def _map_copy_request_fulfilled(self):
        with self._map_copy_cond:
            self._map_copy_requested = False
            self._map_copy_cond.notify_all()

    def _wait_map_copy_to_finish(self):
        with self._map_copy_cond:
            self._map_copy_cond.wait_for(lambda: not self._map_copy_requested)

    def _wait_map_copy_request(self):
        with self._map_copy_cond:
            self._map_copy_cond.wait_for(
                lambda: self._map_copy_requested or self._should_quit)

    # ------------------------------------------------------------------

    def _work(self) -> None:
        """Backend thread loop (reference: mapper.cpp:229-279)."""
        p = self.settings.parameters.slam
        while True:
            item = self.backend_queue.wait_and_dequeue()
            if item is None:
                break
            current_frame_number = self._backend_frame_counter
            self._backend_frame_counter += 1
            delay = p.backendProcessDelay
            if current_frame_number == 0 or delay == 0 or item.keyframe_decision:
                if delay:
                    future = self.backend_queue.task(delay - 1)
                    if future is not None:
                        # splice refined pose-trail info from the future frame
                        # (mapper.cpp:242-266); MapperInput stays immutable
                        new_input = dataclasses.replace(item.mapper_input)
                        new_trail = []
                        future_trail = future.mapper_input.pose_trail
                        future_by_number = {fp.frame_number: fp
                                            for fp in future_trail}
                        for i, pose in enumerate(item.mapper_input.pose_trail):
                            fp = future_by_number.get(pose.frame_number)
                            if fp is not None:
                                new_trail.append(fp)
                            elif i == 0:
                                new_trail.append(pose)
                        new_input.pose_trail = new_trail
                        item = dataclasses.replace(item, mapper_input=new_input)
                self._process_backend_frame(item)
            if (current_frame_number + 1) % p.copySlamMapEveryNSlamFrames == 0:
                if p.deterministicSlamMapCopy:
                    self._wait_map_copy_request()
                if not self._should_quit:
                    self._copy_map()
                if p.deterministicSlamMapCopy:
                    self._map_copy_request_fulfilled()

    def _copy_map(self) -> None:
        """reference: mapper.cpp:281-326"""
        p = self.settings.parameters.slam
        # a deferred BA must land before the snapshot is taken
        finalize_pending_ba(self.map_db, self.settings, self.workspace_ba,
                            self.loop_closer, self.bow_index,
                            self.viewer_publisher)
        partial = p.copyPartialMapToFrontend
        latest = self.map_db.latest_keyframe()
        if latest is None and partial:
            partial = False
        if partial:
            adjacent = compute_adjacent_keyframes(
                latest, 5, p.adjacentSpaceSize, self.map_db, self.settings)
            active = set(adjacent)
            active.add(latest.id)
            new_map = self.map_db.copy_partial(active)
        else:
            new_map = self.map_db.copy()
        with self._frontend_map_mutex:
            self._fast_forward(new_map)
            self.frontend_map_db = new_map

    def _fast_forward(self, new_map: MapDB) -> None:
        """Replay queued frames onto the fresh snapshot (mapper.cpp:328-343)."""
        for item in self.backend_queue.all():
            if item is None:
                continue
            if item.keyframe.id not in new_map.keyframes:
                add_keyframe_frontend(new_map, item.keyframe.copy(),
                                      item.keyframe_decision,
                                      item.mapper_input, self.settings,
                                      device=self.device)

    # ------------------------------------------------------------------

    @timed_as("mapper.prefetch")
    def prefetch(self, mapper_input: MapperInput) -> None:
        """Dispatch the front-end for a FUTURE frame asynchronously so its
        device work overlaps the current frame's host pipeline. Safe to call
        for any frame; non-keyframes simply never collect the result."""
        ex = self._get_orb_extractor(mapper_input)
        if hasattr(ex, "prefetch"):
            ex.prefetch(mapper_input.pose_trail[0].frame_number,
                        mapper_input.frame, mapper_input.track_pts,
                        mapper_input.track_ids)

    @timed_as("mapper.add_frame")
    def advance(self, mapper_input: MapperInput) -> Tuple[np.ndarray, List[dict]]:
        """Process one frame; returns (pose, point cloud)
        (reference: mapper.cpp:345-404)."""
        p = self.settings.parameters.slam
        if not p.useFrontendSlam:
            return self._backend_only(mapper_input)

        kf = Keyframe(mapper_input)
        with self._frontend_map_mutex:
            decision = make_keyframe_decision(
                kf, self.frontend_map_db.latest_keyframe(),
                mapper_input.track_ids, p)
        kf_backend = kf.copy()

        if p.deterministicSlamMapCopy:
            self._wait_map_copy_to_finish()

        with self._frontend_map_mutex:
            self.backend_queue.push(InputFrame(kf_backend, decision, mapper_input))
            _, result_pose, point_cloud = add_keyframe_frontend(
                self.frontend_map_db, kf, decision, mapper_input, self.settings,
                device=self.device)
            self.workspace_ba.ba_stats.finish_frame()

        current_frame_number = self._frontend_frame_counter
        self._frontend_frame_counter += 1
        backend_total_delay = (int(p.copySlamMapEveryNSlamFrames) * 2
                               + int(p.backendProcessDelay) - 1)
        if (p.deterministicSlamMapCopy
                and current_frame_number >= backend_total_delay
                and (current_frame_number + 1) % p.copySlamMapEveryNSlamFrames == 0):
            self._request_map_copy()
        return result_pose, point_cloud

    def _backend_only(self, mapper_input: MapperInput):
        """reference: mapper.cpp:406-434"""
        kf = Keyframe(mapper_input)
        decision = make_keyframe_decision(
            kf, self.map_db.latest_keyframe(), mapper_input.track_ids,
            self.settings.parameters.slam)
        item = InputFrame(kf, decision, mapper_input)
        pose, cloud = self._process_backend_frame(item)
        self.workspace_ba.ba_stats.finish_frame()
        return pose, cloud

    def _process_backend_frame(self, item: InputFrame):
        """reference: mapper.cpp:436-454"""
        _, pose, cloud = add_keyframe_backend(
            self.map_db, item.keyframe, item.keyframe_decision,
            item.mapper_input, self.settings, self.workspace_ba,
            self.loop_closer, self._get_orb_extractor(item.mapper_input),
            self.bow_index, self.viewer_publisher)
        return pose, cloud

    # ------------------------------------------------------------------

    def _stop_and_join(self) -> None:
        """reference: mapper.cpp:179-192"""
        if self._thread is not None:
            self.backend_queue.set_delay(0)
            self._should_quit = True
            with self._map_copy_cond:
                self._map_copy_cond.notify_all()
            self.backend_queue.push(None)
            self._thread.join()
            self._thread = None

    def end(self, map_pose_save_path: str = "") -> bool:
        """Shutdown: drain, audit, persist (reference: mapper.cpp:498-554)."""
        self._stop_and_join()
        finalize_pending_ba(self.map_db, self.settings, self.workspace_ba,
                            self.loop_closer, self.bow_index,
                            self.viewer_publisher)
        check_consistency(self.map_db)
        p = self.settings.parameters.slam
        if p.mapdbSavePath:
            save_map_db(self.map_db, p.mapdbSavePath)
        if map_pose_save_path:
            save_trajectory_csv(self.map_db, map_pose_save_path,
                                self.settings.parameters.imuToCamera)
        if self.end_debug_callback is not None:
            self.end_debug_callback(list(self.map_db.map_point_records.values()))
        return True

    def connect_debug_api(self, viewer_publisher=None, end_debug_callback=None,
                          command_queue=None):
        """reference: mapper.cpp:477-496 (DebugAPI: dataPublisher,
        endDebugCallback, commandQueue)"""
        if viewer_publisher is not None:
            self.viewer_publisher = viewer_publisher
            if hasattr(viewer_publisher, "set_atlas"):
                viewer_publisher.set_atlas(self.atlas)
            self.loop_closer.data_publisher = viewer_publisher
        if command_queue is not None:
            self.loop_closer.commands = command_queue
        if end_debug_callback is not None:
            self.end_debug_callback = end_debug_callback
