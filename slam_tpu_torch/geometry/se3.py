"""SE(3)/Sim(3) host-side utilities (NumPy).

These back the map-layer control flow: pose chaining, loop-closure Sim3
algebra and interpolation, trajectory export. The batched/differentiable
counterparts used inside jitted TPU kernels live in `slam_tpu_torch/ops/lie.py`.

Semantics mirror the reference:
  - poses are stored as 4x4 world-to-camera matrices ``poseCW``
    (reference: keyframe.hpp:168-175),
  - camera centers come from ``worldToCameraMatrixCameraCenter``
    (reference: keyframe.hpp:23-25),
  - Sim3 composition/interpolation matches g2o::Sim3 and the loop closer's
    ``interpolateSim3`` (reference: loop_closer.cpp:53-76).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def camera_center(pose_cw: np.ndarray) -> np.ndarray:
    """Camera position in world coords from a world-to-camera matrix."""
    R = pose_cw[:3, :3]
    t = pose_cw[:3, 3]
    return -R.T @ t


def inverse_pose(pose: np.ndarray) -> np.ndarray:
    """Closed-form inverse of a rigid 4x4 transform."""
    out = np.eye(4)
    R = pose[:3, :3]
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ pose[:3, 3]
    return out


# ---------------------------------------------------------------------------
# SO(3) / quaternion helpers
# ---------------------------------------------------------------------------

def rmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (x, y, z, w)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def quat_to_rmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def quat_slerp(q0: np.ndarray, q1: np.ndarray, lam: float) -> np.ndarray:
    """Spherical linear interpolation between two unit quaternions."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1 = -q1
        dot = -dot
    if dot > 0.9995:
        out = q0 + lam * (q1 - q0)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(np.clip(dot, -1.0, 1.0))
    theta = theta0 * lam
    s0 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta0)
    s1 = np.sin(theta) / np.sin(theta0)
    return s0 * q0 + s1 * q1


def so3_exp(omega: np.ndarray) -> np.ndarray:
    """Rodrigues' formula: axis-angle vector -> rotation matrix."""
    theta = np.linalg.norm(omega)
    if theta < 1e-12:
        return np.eye(3) + skew(omega)
    K = skew(omega / theta)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector."""
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    if abs(np.pi - theta) < 1e-6:
        # near pi: extract axis from the symmetric part
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.clip(np.diag(A), 0.0, None))
        # fix signs using off-diagonals
        if A[0, 1] < 0:
            axis[1] = -axis[1]
        if A[0, 2] < 0:
            axis[2] = -axis[2]
        n = np.linalg.norm(axis)
        if n < 1e-12:
            return np.zeros(3)
        return theta * axis / n
    return theta / (2.0 * np.sin(theta)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def skew(v: np.ndarray) -> np.ndarray:
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def se3_log(T: np.ndarray) -> np.ndarray:
    """SE(3) matrix -> tangent [omega, upsilon] (rotation first, g2o order)."""
    omega = so3_log(T[:3, :3])
    theta = np.linalg.norm(omega)
    if theta < 1e-12:
        Vinv = np.eye(3) - 0.5 * skew(omega)
    else:
        K = skew(omega / theta)
        half = theta / 2.0
        cot_half = 1.0 / np.tan(half)
        Vinv = (np.eye(3) - 0.5 * skew(omega)
                + (1.0 - half * cot_half) * (K @ K))
    upsilon = Vinv @ T[:3, 3]
    return np.concatenate([omega, upsilon])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Tangent [omega, upsilon] -> SE(3) matrix."""
    omega, upsilon = xi[:3], xi[3:]
    theta = np.linalg.norm(omega)
    R = so3_exp(omega)
    if theta < 1e-12:
        V = np.eye(3) + 0.5 * skew(omega)
    else:
        K = skew(omega / theta)
        V = (np.eye(3) + (1 - np.cos(theta)) / theta * K
             + (theta - np.sin(theta)) / theta * (K @ K))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ upsilon
    return T


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Sim3:
    """Similarity transform p' = s * R p + t (g2o::Sim3 semantics)."""
    R: np.ndarray
    t: np.ndarray
    s: float = 1.0

    @staticmethod
    def identity() -> "Sim3":
        return Sim3(np.eye(3), np.zeros(3), 1.0)

    @staticmethod
    def from_se3(T: np.ndarray) -> "Sim3":
        """SE3 -> Sim3 with unit scale (reference: loop_closer.cpp:53-59)."""
        return Sim3(T[:3, :3].copy(), T[:3, 3].copy(), 1.0)

    def to_se3(self) -> np.ndarray:
        """Drop the scale into a rigid 4x4 (reference: loop_closer.cpp:61-66).

        Note: like the reference's sim3ToSe3, the scale is NOT folded into R —
        it is discarded, keeping only rotation and translation.
        """
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T

    def map(self, p: np.ndarray) -> np.ndarray:
        return self.s * (self.R @ p) + self.t

    def __mul__(self, other: "Sim3") -> "Sim3":
        return Sim3(
            self.R @ other.R,
            self.s * (self.R @ other.t) + self.t,
            self.s * other.s,
        )

    def inverse(self) -> "Sim3":
        Rinv = self.R.T
        sinv = 1.0 / self.s
        return Sim3(Rinv, -sinv * (Rinv @ self.t), sinv)


def interpolate_sim3(T0: Sim3, T1: Sim3, lam: float) -> Sim3:
    """Time interpolation used when smearing a loop-closure correction over
    intermediate keyframes (reference: loop_closer.cpp:69-76): quaternion
    slerp on rotation, linear interpolation on translation and scale."""
    assert 0.0 <= lam <= 1.0
    q0 = rmat_to_quat(T0.R)
    q1 = rmat_to_quat(T1.R)
    return Sim3(
        quat_to_rmat(quat_slerp(q0, q1, lam)),
        T0.t + lam * (T1.t - T0.t),
        T0.s + lam * (T1.s - T0.s),
    )


def replace_pose_orientation_keep_position(pose_cw: np.ndarray, new_rot: np.ndarray) -> np.ndarray:
    """Swap the rotation of a world-to-camera pose, preserving the camera
    center (mirrors odometry::util::replacePoseOrientationKeepPosition used at
    mapdb.cpp:6-13)."""
    center = camera_center(pose_cw)
    out = np.eye(4)
    out[:3, :3] = new_rot
    out[:3, 3] = -new_rot @ center
    return out


def remove_rotation_z_tilt(R: np.ndarray) -> np.ndarray:
    """Project a rotation to a pure yaw (z-axis) rotation, dropping tilt
    (mirrors odometry::util::removeRotationMatrixZTilt used at mapdb.cpp:6-13).

    Finds the z-rotation closest to R in the least-squares sense over the
    upper-left 2x2 block (same as Procrustes onto SO(2))."""
    c = R[0, 0] + R[1, 1]
    s = R[1, 0] - R[0, 1]
    n = np.hypot(c, s)
    if n < 1e-12:
        return np.eye(3)
    c, s = c / n, s / n
    out = np.eye(3)
    out[0, 0] = c
    out[0, 1] = -s
    out[1, 0] = s
    out[1, 1] = c
    return out
