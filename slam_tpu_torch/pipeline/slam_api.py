"""Public SLAM session API.

Rebuild of the reference API layer (reference: slam_implementation.{hpp,cpp}):
``Slam.build()`` creates a session; ``add_frame()`` enqueues one frame and
returns a future resolving to ``Result{pose_mat, point_cloud}``; ``end()``
flushes, audits, saves, and shuts down. With ``slamThread`` enabled a
dedicated worker thread decouples the host VIO loop from SLAM latency
(Worker, slam_implementation.cpp:23-188) with a bounded result ring. The
session's device work runs on the device given to ``build`` (the card
unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from slam_tpu_torch.map.keyframe import MapperInput, Pose
from slam_tpu_torch.params import Parameters
from slam_tpu_torch.pipeline.mapper import Mapper

MAX_QUEUED_RESULTS = 100  # reference: slam_implementation.cpp:57


@dataclasses.dataclass
class Result:
    """reference: api Slam::Result (slam_implementation.cpp:169-180)"""
    pose_mat: np.ndarray
    point_cloud: List[dict]


class Slam:
    """reference: SlamImplementation (slam_implementation.cpp:190-227)"""

    def __init__(self, parameters: Parameters, orb_extractor=None,
                 device="cuda"):
        self._parameters = parameters
        self._mapper = Mapper(parameters, orb_extractor=orb_extractor,
                              device=device)
        self._map_save_path = ""
        self._thread: Optional[threading.Thread] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._pending_results = 0
        self._lock = threading.Lock()
        if parameters.slam.slamThread:
            self._thread = threading.Thread(target=self._work, daemon=True)
            self._thread.start()

    @staticmethod
    def build(parameters: Parameters, orb_extractor=None,
              device="cuda") -> "Slam":
        """reference: slam_implementation.cpp:230-232"""
        return Slam(parameters, orb_extractor=orb_extractor, device=device)

    # ------------------------------------------------------------------

    def add_frame(self, frame, pose_trail: List[Pose], features_ids,
                  features_pts, color_frame=None, camera=None,
                  feature_depths=None, depth_map=None,
                  stereo_point_cloud=None) -> "Future[Result]":
        """Submit one frame (reference: slam_implementation.cpp:203-221)."""
        mapper_input = MapperInput(
            frame=frame,
            camera=camera,
            track_ids=np.asarray(features_ids, np.int64),
            track_pts=np.asarray(features_pts, np.float32),
            track_depths=feature_depths,
            pose_trail=pose_trail,
            t=pose_trail[0].t,
            color_frame=color_frame,
            depth_map=depth_map,
            stereo_point_cloud=stereo_point_cloud)
        fut: "Future[Result]" = Future()
        if self._thread is None:
            self._process(mapper_input, fut)
        else:
            with self._lock:
                if self._pending_results >= MAX_QUEUED_RESULTS:
                    raise RuntimeError("result ring exhausted: consume futures")
                self._pending_results += 1
            self._queue.put(("frame", mapper_input, fut))
        return fut

    def end(self) -> "Future[bool]":
        """reference: slam_implementation.cpp:223-226"""
        fut: "Future[bool]" = Future()
        if self._thread is None:
            fut.set_result(self._mapper.end(self._map_save_path))
        else:
            self._queue.put(("end", None, fut))
            self._thread.join()
            self._thread = None
        return fut

    def connect_debug_api(self, viewer_publisher=None, end_debug_callback=None,
                          map_save_path: str = "", command_queue=None) -> None:
        """reference: slam_implementation.cpp:199-201, connectDebugAPI
        (DebugAPI carries dataPublisher + commandQueue + mapSavePath +
        endDebugCallback, slam_implementation.hpp:15-20)"""
        self._mapper.connect_debug_api(viewer_publisher, end_debug_callback,
                                       command_queue=command_queue)
        self._map_save_path = map_save_path

    @property
    def mapper(self) -> Mapper:
        return self._mapper

    # ------------------------------------------------------------------

    def _process(self, mapper_input: MapperInput, fut: "Future[Result]") -> None:
        try:
            pose, cloud = self._mapper.advance(mapper_input)
            fut.set_result(Result(pose_mat=pose, point_cloud=cloud))
        except BaseException as exc:  # propagate through the future
            fut.set_exception(exc)

    def _work(self) -> None:
        while True:
            kind, payload, fut = self._queue.get()
            if kind == "frame":
                self._process(payload, fut)
                with self._lock:
                    self._pending_results -= 1
            elif kind == "end":
                try:
                    fut.set_result(self._mapper.end(self._map_save_path))
                except BaseException as exc:
                    fut.set_exception(exc)
                return
