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


# Jacobians of the SE3 edge and prior errors. The JAX package takes them
# with jacfwd; these are the same forward-mode derivatives written out:
# exp's derivative at 0 is the generator, products and the inverse follow
# the product rule, and se3_log's tangent follows its own formulas (the
# same branches and the same derivative of each op as autograd's), with the
# six tangent directions on a leading axis.

def _generators(T):
    """(6, 1, ..., 1, 4, 4) derivatives of se3_exp at 0 along each tangent
    axis, shaped to broadcast against the batch of (..., 4, 4) poses T."""
    g = torch.zeros(6, 4, 4, dtype=T.dtype, device=T.device)
    g[:3, :3, :3] = skew(_eye(3, T))
    g[3:, :3, 3] = _eye(3, T)
    return g.reshape((6,) + (1,) * (T.dim() - 2) + (4, 4))


def _inverse_jvp(T, dT):
    """Tangent of ``se3_inverse`` at T along dT."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    dRt = dT[..., :3, :3].transpose(-1, -2)
    dti = -((dRt @ t[..., None])[..., 0]
            + (Rt @ dT[..., :3, 3][..., None])[..., 0])
    top = torch.cat([dRt, dti[..., :, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def _so3_log_jvp(R, dR):
    """``so3_log`` and its tangent along dR."""
    x = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0
    dx = (dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]) / 2.0
    cos_t = torch.clamp(x, -1.0, 1.0)
    dcos = torch.where((x >= -1.0) & (x <= 1.0), dx, torch.zeros_like(dx))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    dw = torch.stack([dR[..., 2, 1] - dR[..., 1, 2],
                      dR[..., 0, 2] - dR[..., 2, 0],
                      dR[..., 1, 0] - dR[..., 0, 1]], dim=-1)
    small = cos_t > 1.0 - 1e-7
    cos_safe = torch.where(small, torch.zeros_like(cos_t), cos_t)
    dcos_safe = torch.where(small, torch.zeros_like(dcos), dcos)
    theta = torch.arccos(cos_safe)
    dtheta = dcos_safe * -((-cos_safe * cos_safe + 1.0).rsqrt())
    sin_t = torch.sin(theta)
    dsin = dtheta * torch.cos(theta)
    w2 = torch.sum(w * w, dim=-1)
    dw2 = torch.sum(dw * w + w * dw, dim=-1)
    den = torch.where(small, torch.ones_like(sin_t), 2.0 * sin_t)
    dden = torch.where(small, torch.zeros_like(dsin), 2.0 * dsin)
    scale = torch.where(small, 0.5 + w2 / 48.0, theta / den)
    dscale = torch.where(small, dw2 / 48.0,
                         dtheta / den - dden * (theta / den) / den)
    return w * scale[..., None], dw * scale[..., None] + w * dscale[..., None]


def _se3_log_jvp(T, dT):
    """``se3_log`` (..., 6) and its tangent along dT."""
    t, dt = T[..., :3, 3], dT[..., :3, 3]
    omega, domega = _so3_log_jvp(T[..., :3, :3], dT[..., :3, :3])
    theta2 = torch.sum(omega * omega, dim=-1)
    dtheta2 = torch.sum(domega * omega + omega * domega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    dtheta = dtheta2 / (2.0 * theta)         # inf at 0: only the large branch
    small = theta < 1e-5
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    K, dK = skew(omega), skew(domega)
    half, dhalf = theta / 2.0, dtheta / 2.0
    sin_h = torch.where(small, one, torch.sin(half))
    dsin_h = torch.where(small, zero, dhalf * torch.cos(half))
    hc = half * torch.cos(half)
    dhc = dhalf * torch.cos(half) + half * (dhalf * -torch.sin(half))
    q = hc / sin_h
    dq = dhc / sin_h - dsin_h * q / sin_h
    den = torch.where(small, one, theta2)
    dden = torch.where(small, zero, dtheta2)
    big = (1.0 - q) / den
    dbig = -dq / den - dden * big / den
    cot_term = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, big)
    dcot = torch.where(small, dtheta2 / 720.0, dbig)
    KK = K @ K
    Vinv = _eye(3, T) - 0.5 * K + cot_term[..., None, None] * KK
    dVinv = (-0.5 * dK + dcot[..., None, None] * KK
             + cot_term[..., None, None] * (dK @ K + K @ dK))
    ups = (Vinv @ t[..., None])[..., 0]
    dups = (dVinv @ t[..., None])[..., 0] + (Vinv @ dt[..., None])[..., 0]
    return torch.cat([omega, ups], dim=-1), torch.cat([domega, dups], dim=-1)


def edge_error_and_jacobians(Ta, Tb, C):
    """EdgeSE3Expmap error e = log(inv(exp(xb) Tb) C exp(xa) Ta) at
    xa = xb = 0 (..., 6) and its Jacobians in the left-multiplied tangents
    (..., 6, 6) each: ``jacfwd`` of the reference's ``_pe_error_fn``."""
    G = _generators(Ta)
    Binv = se3_inverse(Tb)
    M = Binv @ C
    E = M @ Ta
    dE_a = M @ (G @ Ta)                                # (6, ..., 4, 4)
    dE_b = (_inverse_jvp(Tb, G @ Tb) @ C) @ Ta
    e, de_a = _se3_log_jvp(E, dE_a)
    _, de_b = _se3_log_jvp(E, dE_b)
    return e, de_a.movedim(0, -1), de_b.movedim(0, -1)


def prior_error_and_jacobian(T, P0):
    """Unary SE3 prior e = log(inv(exp(x) T) P0) at x = 0 (..., 6) and its
    Jacobian (..., 6, 6): ``jacfwd`` of the reference's prior error."""
    G = _generators(T)
    E = se3_inverse(T) @ P0
    e, de = _se3_log_jvp(E, _inverse_jvp(T, G @ T) @ P0)
    return e, de.movedim(0, -1)


def _homogeneous(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = _eye(4, R)[3:].expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)
