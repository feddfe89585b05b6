"""Two-view triangulation (port of ``triangulate_two_view_jax`` from
slam_tpu/ops/ransac.py; the RANSAC solvers are not on the VO path)."""
from __future__ import annotations

import torch


def triangulate_two_view(R_21, t_21, b1, b2):
    """Batched two-view midpoint triangulation.

    ``R_21`` (..., 3, 3), ``t_21`` (..., 3): pose of camera 1 in camera 2
    (p2 = R21 p1 + t21); ``b1, b2``: (..., N, 3) bearings. Returns (..., N,
    3) points in camera-1 coordinates and an (..., N) front-of-both-cameras
    mask."""
    c2 = -torch.einsum("...ji,...j->...i", R_21, t_21)         # -R21^T t21
    d1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True),
                          min=1e-12)
    d2 = b2 @ R_21
    d2 = d2 / torch.clamp(torch.linalg.norm(d2, dim=-1, keepdim=True),
                          min=1e-12)
    eye = torch.eye(3, dtype=b1.dtype, device=b1.device)
    M1 = eye - d1[..., :, None] * d1[..., None, :]
    M2 = eye - d2[..., :, None] * d2[..., None, :]
    A = M1 + M2
    rhs = torch.einsum("...nij,...j->...ni", M2, c2)
    # damped solve keeps parallel-ray systems finite; the cheirality and
    # parallax test below masks them
    pts = torch.linalg.solve_ex(A + 1e-6 * eye, rhs[..., None])[0][..., 0]
    z1 = torch.sum(pts * d1, dim=-1)
    z2 = torch.sum((pts - c2[..., None, :]) * d2, dim=-1)
    parallax = torch.sum(d1 * d2, dim=-1)
    ok = (z1 > 1e-6) & (z2 > 1e-6) & (parallax < 1.0 - 1e-7)
    return pts, ok
