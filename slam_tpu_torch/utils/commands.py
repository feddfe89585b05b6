"""Interactive step-mode command queue.

Rebuild of the reference's host ``CommandQueue`` contract (the external
``../commandline/command_queue.hpp`` of SURVEY.md L0): when step mode is
``SLAM``, the pipeline pauses at the loop-closure stages — start of
``correctLoop``, after the rigid transform, after the linear (interpolated
Sim3) correction, after merge/dedup, and after the post-loop bundle adjust
(reference wait sites: loop_closer.cpp:382-386, 436-440, 478-482, 552-555;
mapper_helpers.cpp:1116-1120) — publishing a viewer snapshot before each
wait so the operator can inspect the map between stages.

Headless-friendly: the default wait function reads a line from stdin only
when stdin is a TTY; otherwise every wait is a recorded no-op, so the same
hooks double as a stage trace in tests and batch runs (``waits`` keeps the
ordered stage messages).
"""
from __future__ import annotations

import enum
import sys
from typing import Callable, List, Optional


class StepMode(enum.Enum):
    NONE = 0
    ODOMETRY = 1   # reserved by the host contract; unused by the SLAM module
    SLAM = 2


class CommandQueue:
    """reference contract: commands->getStepMode() / waitForAnyKey()."""

    def __init__(self, step_mode: StepMode = StepMode.NONE,
                 wait_fn: Optional[Callable[[str], None]] = None):
        self._step_mode = step_mode
        self._wait_fn = wait_fn
        self.waits: List[str] = []

    def set_step_mode(self, mode: StepMode) -> None:
        self._step_mode = mode

    def get_step_mode(self) -> StepMode:
        return self._step_mode

    def wait_for_any_key(self, message: str = "") -> None:
        """Record the stage and block per the configured wait function."""
        self.waits.append(message)
        if self._wait_fn is not None:
            self._wait_fn(message)
        elif sys.stdin is not None and sys.stdin.isatty():
            input(f"[step] {message} — press enter to continue")


def step_wait(commands: Optional[CommandQueue], data_publisher, map_db,
              workspace_ba, parameters, message: str) -> None:
    """The reference's guarded publish-then-wait idiom, shared by all sites
    (``if (dataPublisher && commands && stepMode == SLAM) { publish; wait }``).
    """
    if (commands is None or data_publisher is None
            or commands.get_step_mode() != StepMode.SLAM):
        return
    data_publisher.publish_map(map_db, workspace_ba, parameters)
    commands.wait_for_any_key(message)
