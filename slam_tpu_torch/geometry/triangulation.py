"""Closed-form triangulation (host NumPy; batched TPU versions in ops/triangulate.py).

Replaces the reference's use of the Theia library (`theia::Triangulate`,
`TriangulateNView`, `TriangulateMidpoint`, called from
mapper_helpers.cpp:657-690, 766-771) with standard closed-form solvers:

  - two-view DLT: nullspace of the 4x4 design matrix built from
    ``x * P.row(2) - P.row(0/1)`` constraints,
  - N-view: smallest eigenvector of the accumulated projection cost matrix,
  - midpoint: least-squares point closest to all rays.

All accept world-to-camera 3x4 projection matrices in *normalized* camera
coordinates (the reference normalizes pixels first via
``camera->normalizePixel``, mapper_helpers.cpp:667).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def triangulate_two_view(pose1: np.ndarray, pose2: np.ndarray,
                         x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, bool]:
    """DLT triangulation from two normalized observations.

    pose1/pose2: (3,4) world-to-camera projections; x1/x2: (2,) normalized
    image points. Returns (homogeneous 4-vector, ok).
    """
    A = np.stack([
        x1[0] * pose1[2] - pose1[0],
        x1[1] * pose1[2] - pose1[1],
        x2[0] * pose2[2] - pose2[0],
        x2[1] * pose2[2] - pose2[1],
    ])
    # nullspace via the eigenvector of A^T A with smallest eigenvalue
    _, _, vt = np.linalg.svd(A)
    X = vt[-1]
    return X, True


def triangulate_n_view(poses: np.ndarray, points: np.ndarray,
                       mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, bool]:
    """N-view triangulation via the accumulated cost matrix.

    poses: (N,3,4), points: (N,2) normalized observations, mask: optional (N,)
    validity. Returns (homogeneous 4-vector, ok).
    """
    poses = np.asarray(poses, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    n = poses.shape[0]
    h = np.concatenate([points, np.ones((n, 1))], axis=1)
    h = h / np.linalg.norm(h, axis=1, keepdims=True)
    proj = np.einsum("ni,nj,njk->nik", h, h, poses)
    cost = poses - proj                              # (n, 3, 4)
    if mask is not None:
        cost = cost * np.asarray(mask, np.float64)[:, None, None]
    design = np.einsum("nij,nik->jk", cost, cost)
    w, v = np.linalg.eigh(design)
    return v[:, 0], True


def triangulate_midpoint(origins: np.ndarray, rays: np.ndarray,
                         mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, bool]:
    """Least-squares point closest to a bundle of rays (world coords).

    origins: (N,3) camera centers, rays: (N,3) unit directions in world.
    Returns (homogeneous 4-vector, ok). ok=False when the system is
    degenerate (parallel rays).
    """
    origins = np.asarray(origins, dtype=np.float64)
    rays = np.asarray(rays, dtype=np.float64)
    A = np.zeros((3, 3))
    b = np.zeros(3)
    n = origins.shape[0]
    for i in range(n):
        if mask is not None and not mask[i]:
            continue
        d = rays[i] / np.linalg.norm(rays[i])
        M = np.eye(3) - np.outer(d, d)
        A += M
        b += M @ origins[i]
    try:
        if np.linalg.cond(A) > 1e10:
            return np.array([0.0, 0.0, 0.0, 1.0]), False
        p = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        return np.array([0.0, 0.0, 0.0, 1.0]), False
    return np.append(p, 1.0), True


def check_triangulation_angle(rays_w: np.ndarray, min_angle_deg: float,
                              mask: Optional[np.ndarray] = None) -> bool:
    """True if ANY pair of world-frame viewing rays subtends at least the
    minimum angle (reference: mapper_helpers.cpp:559-569 — note it returns
    true when a sufficiently wide pair exists)."""
    rays_w = np.asarray(rays_w, dtype=np.float64)
    if mask is not None:
        rays_w = rays_w[np.asarray(mask, dtype=bool)]
    n = rays_w.shape[0]
    if n < 2:
        return False
    cos_min = np.cos(np.radians(min_angle_deg))
    # normalized dot products of all pairs
    norms = np.linalg.norm(rays_w, axis=1, keepdims=True)
    u = rays_w / np.maximum(norms, 1e-12)
    dots = u @ u.T
    iu = np.triu_indices(n, k=1)
    return bool(np.any(dots[iu] < cos_min))
