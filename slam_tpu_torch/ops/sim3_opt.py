"""Sim3 transform refinement (port of slam_tpu/ops/sim3_opt.py): the device
LM of the interactive loop closer, ``optimize_sim3_transform``, and the host
NumPy twin that ``DeviceSlam``'s consumer runs.

Rebuild of ``OptimizeSim3Transform`` (reference: optimize_transform.cpp:
63-155): one Sim3 vertex against fixed point pairs with forward
(EdgeSim3ProjectXYZ) and inverse (EdgeInverseSim3ProjectXYZ) projection
edges in the normalized camera, Huber kernel, 20 iterations. The state is a
7-vector chart [omega, upsilon, sigma] applied as R <- exp(omega) R,
t <- t + upsilon, s <- s * exp(sigma). Like the reference, edges are
weighted by levelSigmaSq, not its inverse (optimize_transform.cpp:122,137).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from slam_tpu_torch.ops import lie


def _apply_chart(delta, R, t, s):
    return lie.so3_exp(delta[:3]) @ R, t + delta[3:6], s * torch.exp(delta[6:])


def _residuals(R, t, s, pts1, pts2, obs1, obs2, w1, w2):
    """(2N, 2) stacked whitened residuals of the forward and inverse
    projection edges at (R, t, s), ``s`` of shape (1,)."""
    # forward: map p2 (cam2 frame) through Sim3_12 -> cam1, compare to obs1
    p_in_1 = s * (pts2 @ R.T) + t
    z1 = torch.where(torch.abs(p_in_1[:, 2]) > 1e-6, p_in_1[:, 2],
                     torch.full_like(p_in_1[:, 2], 1e-6))
    e12 = (obs1 - p_in_1[:, :2] / z1[:, None]) * w1[:, None]
    # inverse: map p1 (cam1 frame) through Sim3_12^-1 -> cam2, compare to obs2
    sinv = 1.0 / s
    Rinv = R.T
    tinv = -sinv * (Rinv @ t)
    p_in_2 = sinv * (pts1 @ Rinv.T) + tinv
    z2 = torch.where(torch.abs(p_in_2[:, 2]) > 1e-6, p_in_2[:, 2],
                     torch.full_like(p_in_2[:, 2], 1e-6))
    e21 = (obs2 - p_in_2[:, :2] / z2[:, None]) * w2[:, None]
    return torch.cat([e12, e21], dim=0)


def _proj_jac(p):
    """(n, 2, 3) Jacobian of the perspective division at p."""
    z = torch.where(torch.abs(p[:, 2]) > 1e-6, p[:, 2],
                    torch.full_like(p[:, 2], 1e-6))
    zero = torch.zeros_like(z)
    return torch.stack([torch.stack([1.0 / z, zero, -p[:, 0] / (z * z)], -1),
                        torch.stack([zero, 1.0 / z, -p[:, 1] / (z * z)], -1)],
                       dim=-2)


def _jacobian(R, t, s, pts1, pts2, w1, w2):
    """(2N, 2, 7) Jacobian of the stacked residuals at the chart's origin,
    analytic (the host twin's derivation). Forward edge: p = s R p2 + t,
    dp/dw = -skew(s R p2), dp/du = I, dp/dsigma = s R p2. Inverse edge:
    q = s^-1 R^T (p1 - t), dq/dw = s^-1 R^T skew(p1 - t),
    dq/du = -s^-1 R^T, dq/dsigma = -q. Residual e = (obs - proj(.)) w."""
    n = len(pts1)
    v = s * (pts2 @ R.T)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(n, 3, 3)
    dP = torch.cat([-lie.skew(v), eye, v[:, :, None]], dim=-1)
    J12 = -(_proj_jac(v + t) @ dP) * w1[:, None, None]
    sinv = 1.0 / s
    u = pts1 - t
    q = sinv * (u @ R)                                # R^T u, row form
    dQ = torch.cat([sinv * (R.T @ lie.skew(u)),
                    (-sinv * R.T).expand(n, 3, 3), -q[:, :, None]], dim=-1)
    J21 = -(_proj_jac(q) @ dQ) * w2[:, None, None]
    return torch.cat([J12, J21], dim=0)


def _optimize(R, t, s, pts1, pts2, obs1, obs2, w1, w2, huber_delta: float,
              iterations: int, fix_scale: bool):
    """The LM loop on tensors: Huber weights, damping x0.5 on accept and x4
    on reject, the scale row masked when ``fix_scale``. No host sync."""
    dt, dev = R.dtype, R.device
    eye7 = torch.eye(7, dtype=dt, device=dev)
    # the reference squares the f32 delta in f32
    d2 = float(np.float32(huber_delta) * np.float32(huber_delta))
    data = (pts1, pts2, obs1, obs2, w1, w2)

    def cost_of(R, t, s):
        r = _residuals(R, t, s, *data)
        chi2 = torch.sum(r * r, dim=1)
        rho = torch.where(chi2 <= d2, chi2, 2.0 * huber_delta
                          * torch.sqrt(torch.clamp(chi2, min=1e-12)) - d2)
        return torch.sum(rho)

    scale_row = torch.zeros(7, dtype=torch.bool, device=dev)
    scale_row[6] = bool(fix_scale)
    keep = ~(scale_row[:, None] | scale_row[None, :])
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = cost_of(R, t, s)
    for _ in range(int(iterations)):
        r0 = _residuals(R, t, s, *data)
        J = _jacobian(R, t, s, pts1, pts2, w1, w2)
        chi2 = torch.sum(r0 * r0, dim=1)
        wq = torch.sqrt(torch.clamp(
            huber_delta / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0))
        Jf = (J * wq[:, None, None]).reshape(-1, 7)
        rf = (r0 * wq[:, None]).reshape(-1)
        H = Jf.T @ Jf + lam * eye7
        g = -Jf.T @ rf
        # fixed scale: zero the scale row/col, keep a unit diagonal
        H = torch.where(keep, H, torch.zeros_like(H)) + torch.diag(
            scale_row.to(dt))
        g = torch.where(scale_row, torch.zeros_like(g), g)
        delta = torch.linalg.solve_ex(H, g)[0]
        Rn, tn, sn = _apply_chart(delta, R, t, s)
        new_cost = cost_of(Rn, tn, sn)
        accept = new_cost < cost
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        s = torch.where(accept, sn, s)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return R, t, s


def optimize_sim3_transform(rot_12: np.ndarray, trans_12: np.ndarray,
                            scale_12: float,
                            pts1_cam: np.ndarray, pts2_cam: np.ndarray,
                            obs1: np.ndarray, obs2: np.ndarray,
                            sigma_sq1: np.ndarray, sigma_sq2: np.ndarray,
                            inlier_threshold: float,
                            fix_scale: bool,
                            iterations: int = 20, *, device
                            ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Refine (R, t, s) of the cam2->cam1 similarity on ``device``, in f32.

    pts1_cam/pts2_cam: (N, 3) matched map points in each camera frame;
    obs1/obs2: (N, 2) normalized-camera observations (bearing.xy/z);
    sigma_sq*: per-match levelSigmaSq (used as edge information, see module
    docstring). One host copy of the result at the end."""
    n = len(pts1_cam)
    if n == 0:
        return rot_12, trans_12, scale_12
    from slam_tpu_torch.precision import pin_full_f32

    pin_full_f32()
    put = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(device)
    R, t, s = _optimize(
        put(rot_12), put(trans_12), put([scale_12]),
        put(np.reshape(pts1_cam, (n, 3))), put(np.reshape(pts2_cam, (n, 3))),
        put(np.reshape(obs1, (n, 2))), put(np.reshape(obs2, (n, 2))),
        put(np.sqrt(np.asarray(sigma_sq1, np.float32))),
        put(np.sqrt(np.asarray(sigma_sq2, np.float32))),
        float(np.float32(np.sqrt(inlier_threshold))), int(iterations),
        bool(fix_scale))
    R, t, s = (x.cpu().numpy() for x in (R, t, s))
    return R.astype(np.float64), t.astype(np.float64), float(s[0])


def _residuals_np(delta, R, t, s, pts1, pts2, obs1, obs2, w1, w2):
    """Stacked whitened residuals of the forward and inverse projection
    edges, float64."""
    dR = _so3_exp_np(delta[:3])
    Rn, tn, sn = dR @ R, t + delta[3:6], s * np.exp(delta[6])
    p_in_1 = sn * (pts2 @ Rn.T) + tn
    z1 = np.where(np.abs(p_in_1[:, 2]) > 1e-6, p_in_1[:, 2], 1e-6)
    e12 = (obs1 - p_in_1[:, :2] / z1[:, None]) * w1[:, None]
    sinv = 1.0 / sn
    Rinv = Rn.T
    tinv = -sinv * (Rinv @ tn)
    p_in_2 = sinv * (pts1 @ Rinv.T) + tinv
    z2 = np.where(np.abs(p_in_2[:, 2]) > 1e-6, p_in_2[:, 2], 1e-6)
    e21 = (obs2 - p_in_2[:, :2] / z2[:, None]) * w2[:, None]
    return np.concatenate([e12, e21], axis=0)


def _so3_exp_np(omega):
    theta = np.linalg.norm(omega)
    wx = np.array([[0.0, -omega[2], omega[1]],
                   [omega[2], 0.0, -omega[0]],
                   [-omega[1], omega[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + wx
    K = wx / theta
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def optimize_sim3_transform_host(rot_12, trans_12, scale_12,
                                 pts1_cam, pts2_cam, obs1, obs2,
                                 sigma_sq1, sigma_sq2,
                                 inlier_threshold: float, fix_scale: bool,
                                 iterations: int = 20):
    """Refine (R, t, s) of the cam2 -> cam1 similarity.

    ``pts1_cam``/``pts2_cam``: (N, 3) matched points in each camera frame;
    ``obs1``/``obs2``: (N, 2) normalized-camera observations;
    ``sigma_sq*``: per-match levelSigmaSq. LM with Huber weights, damping
    x0.5 on accept and x4 on reject, the scale row masked when
    ``fix_scale``; the Jacobian is analytic in float64 (see ``_jacobian``),
    and the loop exits early once the step norm vanishes."""
    n = len(pts1_cam)
    if n == 0:
        return rot_12, trans_12, scale_12
    R = np.asarray(rot_12, np.float64)
    t = np.asarray(trans_12, np.float64)
    s = float(scale_12)
    pts1 = np.asarray(pts1_cam, np.float64).reshape(n, 3)
    pts2 = np.asarray(pts2_cam, np.float64).reshape(n, 3)
    obs1 = np.asarray(obs1, np.float64).reshape(n, 2)
    obs2 = np.asarray(obs2, np.float64).reshape(n, 2)
    w1 = np.sqrt(np.asarray(sigma_sq1, np.float64))
    w2 = np.sqrt(np.asarray(sigma_sq2, np.float64))
    huber = float(np.sqrt(inlier_threshold))
    d2 = huber * huber

    def cost_of(R, t, s):
        r = _residuals_np(np.zeros(7), R, t, s, pts1, pts2, obs1, obs2,
                          w1, w2)
        chi2 = np.sum(r * r, axis=1)
        rho = np.where(chi2 <= d2, chi2,
                       2.0 * huber * np.sqrt(np.maximum(chi2, 1e-12)) - d2)
        return float(np.sum(rho))

    def _skew_batch(v):
        out = np.zeros((len(v), 3, 3))
        out[:, 0, 1] = -v[:, 2]
        out[:, 0, 2] = v[:, 1]
        out[:, 1, 0] = v[:, 2]
        out[:, 1, 2] = -v[:, 0]
        out[:, 2, 0] = -v[:, 1]
        out[:, 2, 1] = v[:, 0]
        return out

    def _proj_jac(p):
        """(n, 2, 3) Jacobian of the perspective division at p."""
        z = np.where(np.abs(p[:, 2]) > 1e-6, p[:, 2], 1e-6)
        J = np.zeros((len(p), 2, 3))
        J[:, 0, 0] = 1.0 / z
        J[:, 0, 2] = -p[:, 0] / (z * z)
        J[:, 1, 1] = 1.0 / z
        J[:, 1, 2] = -p[:, 1] / (z * z)
        return J

    def _jacobian(R, t, s):
        """Analytic (2n, 2, 7) Jacobian of the stacked residuals at delta=0.
        Forward edge: p = s R p2 + t, dp/dw = -skew(sRp2), dp/du = I,
        dp/dsigma = sRp2. Inverse edge: q = s^-1 R^T (p1 - t),
        dq/dw = s^-1 R^T skew(p1 - t), dq/du = -s^-1 R^T, dq/dsigma = -q.
        Residual e = (obs - proj(.)) w, so each block is
        -w * projJac @ dP."""
        n = len(pts1)
        v = s * (pts2 @ R.T)                          # (n, 3)
        p = v + t
        dP = np.zeros((n, 3, 7))
        dP[:, :, 0:3] = -_skew_batch(v)
        dP[:, :, 3:6] = np.eye(3)[None]
        dP[:, :, 6] = v
        J12 = -(_proj_jac(p) @ dP) * w1[:, None, None]

        sinv = 1.0 / s
        u = pts1 - t
        q = sinv * (u @ R)                            # R^T u, row-vector form
        dQ = np.zeros((n, 3, 7))
        dQ[:, :, 0:3] = sinv * np.einsum(
            "ji,njk->nik", R, _skew_batch(u), optimize=True)
        dQ[:, :, 3:6] = (-sinv * R.T)[None]
        dQ[:, :, 6] = -q
        J21 = -(_proj_jac(q) @ dQ) * w2[:, None, None]
        return np.concatenate([J12, J21], axis=0)

    lam = 1e-4
    cost = cost_of(R, t, s)
    for _ in range(int(iterations)):
        r0 = _residuals_np(np.zeros(7), R, t, s, pts1, pts2, obs1, obs2,
                           w1, w2)
        J = _jacobian(R, t, s)
        chi2 = np.sum(r0 * r0, axis=1)
        wq = np.sqrt(np.minimum(
            1.0, huber / np.sqrt(np.maximum(chi2, 1e-12))))[:, None]
        Jf = (J * wq[:, :, None]).reshape(-1, 7)
        rf = (r0 * wq).reshape(-1)
        H = Jf.T @ Jf + lam * np.eye(7)
        g = -Jf.T @ rf
        if fix_scale:
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            g[6] = 0.0
        try:
            delta = np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            lam = min(lam * 4.0, 1e6)
            continue
        dR = _so3_exp_np(delta[:3])
        Rn, tn, sn = dR @ R, t + delta[3:6], s * np.exp(delta[6])
        new_cost = cost_of(Rn, tn, sn)
        if new_cost < cost:
            R, t, s, cost = Rn, tn, sn, new_cost
            lam = max(lam * 0.5, 1e-9)
        else:
            lam = min(lam * 4.0, 1e6)
        if np.linalg.norm(delta) < 1e-10:
            break
    return R, t, float(s)
