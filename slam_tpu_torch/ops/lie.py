"""Batched SE(3) Lie-group ops (port of slam_tpu/ops/lie.py).

Tangent convention matches g2o::SE3Quat: [omega, upsilon], rotation first.
Updates are left-multiplicative (T_new = exp(delta) @ T). Every function
broadcasts over leading batch dimensions and keeps the input dtype.
"""
from __future__ import annotations

import torch


def skew(v):
    """(..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def so3_exp(omega):
    """(..., 3) -> (..., 3, 3) via Rodrigues with a small-angle switch."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    K = skew(omega)
    return (_eye(3, omega) + a[..., None, None] * K
            + b[..., None, None] * (K @ K))


def so3_log(R):
    """(..., 3, 3) -> (..., 3); safe for angles < pi - eps.

    The small-angle branch is a series in |w|^2 and the arccos input is
    pushed away from +/-1 on small lanes, so forward-mode Jacobians stay
    finite at the identity (pose edges start at exactly zero error)."""
    cos_t = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
                        / 2.0, -1.0, 1.0)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = cos_t > 1.0 - 1e-7
    cos_safe = torch.where(small, torch.zeros_like(cos_t), cos_t)
    theta = torch.arccos(cos_safe)
    sin_t = torch.sin(theta)
    w2 = torch.sum(w * w, dim=-1)
    scale = torch.where(small, 0.5 + w2 / 48.0,
                        theta / torch.where(small, torch.ones_like(sin_t),
                                            2.0 * sin_t))
    return w * scale[..., None]


def se3_exp(xi):
    """(..., 6) [omega, upsilon] -> (..., 4, 4)."""
    omega = xi[..., :3]
    upsilon = xi[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    one = torch.ones_like(theta)
    R = so3_exp(omega)
    K = skew(omega)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, theta2 * theta))
    V = _eye(3, xi) + b[..., None, None] * K + c[..., None, None] * (K @ K)
    t = (V @ upsilon[..., None])[..., 0]
    return _homogeneous(R, t)


def se3_log(T):
    """(..., 4, 4) -> (..., 6) [omega, upsilon]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    one = torch.ones_like(theta)
    K = skew(omega)
    half = theta / 2.0
    # (1 - half*cot(half)) / theta^2, series: 1/12 + t^2/720
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, one, torch.sin(half)))
        / torch.where(small, one, theta2))
    Vinv = _eye(3, T) - 0.5 * K + cot_term[..., None, None] * (K @ K)
    upsilon = (Vinv @ t[..., None])[..., 0]
    return torch.cat([omega, upsilon], dim=-1)


def se3_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _homogeneous(Rt, ti)


def batched_jacfwd(fn, x, *args):
    """Forward-mode Jacobian of a batched ``fn(x (B, n), *args) -> (B, m)``
    whose rows are independent: (B, m, n), one jvp per input direction.

    Stands in for ``vmap(jacfwd(fn))``: under ``vmap`` the per-row scalars
    of this module are 0-dim, and torch then promotes their tangents to
    float64 when they meet a Python float."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :] \
        .expand(n, x.shape[0], n)

    def push(v):
        return torch.func.jvp(lambda z: fn(z, *args), (x,), (v,))[1]
    return torch.func.vmap(push)(basis).permute(1, 2, 0)


def _homogeneous(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = _eye(4, R)[3:].expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)
