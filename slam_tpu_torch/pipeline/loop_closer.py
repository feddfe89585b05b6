"""The drift-angle gate of loop closure (port of ``drift_gate_angle`` and
``_closest_rotation`` from slam_tpu/pipeline/loop_closer.py; the rest of
that module belongs to the interactive path)."""
from __future__ import annotations

import numpy as np

from slam_tpu_torch.geometry import se3


def drift_gate_angle(U: np.ndarray, cand_pose_cw: np.ndarray,
                     curr_pose_cw: np.ndarray) -> float:
    """Drift angle of a loop-closure correction.

    The relative rotation between the candidate-implied pose of the current
    keyframe and its actual pose (reference: loop_closer.cpp:306-309,
    ``R = (U*candPose).inverse().topLeft().transpose()
    * currPose.inverse().topLeft()``). For a genuine small correction this is
    near identity regardless of the absolute orientation; ``U`` may carry a
    Sim3 scale in its rotation block, which the polar projection removes.
    """
    R = (np.linalg.inv(U @ cand_pose_cw)[:3, :3].T
         @ np.linalg.inv(curr_pose_cw)[:3, :3])
    return float(np.linalg.norm(se3.so3_log(_closest_rotation(R))))


def _closest_rotation(R: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(R)
    out = U @ Vt
    if np.linalg.det(out) < 0:
        out = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    return out
