"""SE(3) host-side utilities (NumPy): the port's copy of the parts of
slam_tpu/geometry/se3.py that it uses, same names.

Tangents are [omega, upsilon], rotation first (g2o order).
"""
from __future__ import annotations

import numpy as np


def so3_exp(omega: np.ndarray) -> np.ndarray:
    """Rodrigues' formula: axis-angle vector -> rotation matrix."""
    theta = np.linalg.norm(omega)
    if theta < 1e-12:
        return np.eye(3) + skew(omega)
    K = skew(omega / theta)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def skew(v: np.ndarray) -> np.ndarray:
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


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
