"""Batched Perspective-n-Point 6DoF recovery (port of the JAX ``ops/pnp.py``).

``points_2d`` are normalized image coordinates ((u - cx) / fx, (v - cy) /
fy); a returned (R, t) maps model points into the pinhole camera frame (X
right, Y down, Z forward): ``p_cam = R @ X + t``. Every solver takes any
leading batch dims (the JAX package vmaps over them).

* ``solve_pnp``: weighted DLT initialization, then fixed-iteration damped
  Gauss-Newton on SE(3).
* ``solve_ground_pose``: the ground prior (upright on the ground plane:
  x, y, yaw free), a yaw grid, then IRLS Gauss-Newton from the best start
  and from its pi-mirror; the lower residual wins.

Both run in f32 with TF32 off in matmuls and convolutions for their whole
duration, whatever the caller set (``_pin_highest``). RANSAC and the crane
solve wait (``ROADMAP.md``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor


def _pin_highest(fn):
    """Run the solver with TF32 off, then restore the caller's setting:
    TF32 keeps ~3 decimal digits, which the normal-equation solves (J^T J)
    cannot afford."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return wrapped


class PnPResult(NamedTuple):
    R: Tensor  # (..., 3, 3)
    t: Tensor  # (..., 3)
    rmse: Tensor  # (...,) weighted reprojection RMSE (normalized coords)
    valid: Tensor  # (...,) bool: enough usable points to solve


def _hat(w: Tensor) -> Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    rows = ([z, -wz, wy], [wz, z, -wx], [-wy, wx, z])
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _exp_so3(w: Tensor) -> Tensor:
    theta = torch.clamp_min(torch.linalg.norm(w, dim=-1, keepdim=True), 1e-12)
    K = _hat(w / theta)
    th = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def dlt_init(points_3d: Tensor, points_2d: Tensor, weights: Tensor):
    """Weighted DLT: (..., N, 3), (..., N, 2), (..., N) -> (R, t)."""
    X = torch.cat([points_3d, torch.ones_like(points_3d[..., :1])], -1)  # (..., N, 4)
    u = points_2d[..., 0:1]
    v = points_2d[..., 1:2]
    zeros = torch.zeros_like(X)
    w = torch.sqrt(torch.clamp_min(weights, 0.0))[..., None]
    r1 = torch.cat([X, zeros, -u * X], -1) * w  # (..., N, 12)
    r2 = torch.cat([zeros, X, -v * X], -1) * w
    A = torch.cat([r1, r2], -2)  # (..., 2N, 12)
    # The smallest right-singular vector, as the eigenvector of A^T A with
    # the smallest eigenvalue.
    _, evecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = evecs[..., :, 0].reshape(*A.shape[:-2], 3, 4)
    # Cheirality: the weighted mean depth must be positive.
    z = torch.einsum("...j,...nj->...n", P[..., 2, :], X)
    sign = torch.sign(torch.sum(z * weights, -1))
    sign = torch.where(sign == 0, 1.0, sign)
    P = P * sign[..., None, None]
    U, S, Vt = torch.linalg.svd(P[..., :, :3])
    detUV = torch.linalg.det(U @ Vt)
    one = torch.ones_like(detUV)
    D = torch.stack([one, one, detUV], -1)
    R = (U * D[..., None, :]) @ Vt
    scale = torch.mean(S * D, -1)
    scale = torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)
    return R, P[..., :, 3] / scale[..., None]


def _project(R: Tensor, t: Tensor, X: Tensor):
    p = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = torch.where(torch.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
    return p[..., :2] / z[..., None], p


@_pin_highest
def solve_pnp(points_3d: Tensor, points_2d: Tensor, weights: Tensor, iters: int = 8,
              damping: float = 1e-4, min_points: int = 6) -> PnPResult:
    """DLT + Gauss-Newton over leading batch dims: points_3d (..., N, 3)
    model-frame points, points_2d (..., N, 2) normalized, weights (..., N).

    ``min_points`` counts correspondences of positive weight: the DLT
    needs 6 for a unique projective solution."""
    valid = torch.sum(weights > 0, -1) >= min_points
    w_safe = torch.where(valid[..., None], weights, torch.ones_like(weights))
    R, t = dlt_init(points_3d, points_2d, w_safe)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        proj, p_cam = _project(R, t, points_3d)
        r = (proj - points_2d) * w_safe[..., None]  # (..., N, 2)
        Xc, Yc, Zc = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        iz = 1.0 / torch.where(torch.abs(Zc) < 1e-9, 1e-9, Zc)
        zr = torch.zeros_like(iz)
        Jp = torch.stack([torch.stack([iz, zr, -Xc * iz * iz], -1),
                          torch.stack([zr, iz, -Yc * iz * iz], -1)], -2)  # (..., N, 2, 3)
        # dp / d[omega, dt] with a left perturbation: -[p]x and I.
        Jw = -_hat(p_cam)
        Jpose = torch.cat([Jw, torch.eye(3, dtype=Jw.dtype, device=Jw.device).expand_as(Jw)],
                          -1)  # (..., N, 3, 6)
        J = (Jp @ Jpose) * w_safe[..., None, None]
        Jf = J.reshape(*J.shape[:-3], -1, 6)
        rf = r.reshape(*r.shape[:-2], -1)
        H = Jf.transpose(-1, -2) @ Jf + damping * eye6
        g = (Jf.transpose(-1, -2) @ rf[..., None])
        delta = -torch.linalg.solve(H, g)[..., 0]
        dR = _exp_so3(delta[..., :3])
        R = dR @ R
        t = (dR @ t[..., None])[..., 0] + delta[..., 3:]
    proj, _ = _project(R, t, points_3d)
    err2 = torch.sum((proj - points_2d) ** 2, -1) * w_safe
    rmse = torch.sqrt(torch.sum(err2, -1) / torch.clamp_min(torch.sum(w_safe, -1), 1e-9))
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R)
    R = torch.where(valid[..., None, None], R, eye)
    t = torch.where(valid[..., None], t, torch.zeros_like(t))
    return PnPResult(R=R, t=t, rmse=rmse, valid=valid)


def normalize_pixels(uv: Tensor, fx, fy, cx, cy) -> Tensor:
    """Pixel -> normalized image coordinates."""
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def _rot_z(yaw: Tensor) -> Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rows = ([c, -s, z], [s, c, z], [z, z, o])
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


@_pin_highest
def solve_ground_pose(points_3d: Tensor, points_2d: Tensor, weights: Tensor, R_wp: Tensor,
                      cam_pos: Tensor, yaw_candidates: int = 16, iters: int = 12,
                      damping: float = 1e-5, min_points: int = 3,
                      huber: float = 0.02) -> PnPResult:
    """Pose under the ground prior over leading batch dims: points_3d
    (..., N, 3) model-frame points (z up, object on z = 0), points_2d
    (..., N, 2) normalized, weights (..., N), R_wp (..., 3, 3)
    world-from-pinhole, cam_pos (..., 3) world. Only (x, y, yaw) are free.

    Start: the weighted-centroid ray dropped to the object's half-height
    plane, and the best of a yaw grid. Refinement: Gauss-Newton on (x, y,
    yaw) with Huber IRLS weights (``huber`` in normalized coords, ~2.5 px),
    from the best yaw and from its pi-mirror; the lower robust residual
    wins. The Jacobian is written out by hand. Returns the CAMERA-frame pose,
    like ``solve_pnp``."""
    valid = torch.sum(weights > 0, -1) >= min_points
    w_safe = torch.where(valid[..., None], weights, torch.ones_like(weights))
    wsum = torch.clamp_min(torch.sum(w_safe, -1), 1e-9)

    # Start: intersect the weighted-centroid ray with z = z_center.
    z_c = torch.mean(points_3d[..., 2], -1)
    uvc = torch.sum(points_2d * w_safe[..., None], -2) / wsum[..., None]
    d_pin = torch.cat([uvc, torch.ones_like(uvc[..., :1])], -1)
    d_w = (R_wp @ d_pin[..., None])[..., 0]
    dz = torch.where(torch.abs(d_w[..., 2]) < 1e-6, 1e-6, d_w[..., 2])
    s = torch.clamp((z_c - cam_pos[..., 2]) / dz, 0.5, 500.0)
    xy0 = (cam_pos + s[..., None] * d_w)[..., :2]

    # A hypothesis axis h before the per-object dims; it broadcasts.
    P3, P2 = points_3d.unsqueeze(-3), points_2d.unsqueeze(-3)  # (..., 1, N, 3|2)
    Rw, cp = R_wp.unsqueeze(-3), cam_pos.unsqueeze(-2)  # (..., 1, 3, 3), (..., 1, 3)
    W = w_safe.unsqueeze(-2)  # (..., 1, N)

    def residuals(params, w):
        """params (..., h, 3), w (..., h or 1, N) -> weighted residuals
        (..., h, N, 2), p_cam (..., h, N, 3), Jacobian (..., h, N, 2, 3)."""
        yaw = params[..., 2]
        c, sn = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]  # (..., h, 1)
        t_w = torch.stack([params[..., 0], params[..., 1], torch.zeros_like(yaw)], -1)
        p_w = P3 @ _rot_z(yaw).transpose(-1, -2) + t_w[..., None, :]
        p_cam = (p_w - cp[..., None, :]) @ Rw
        z = torch.where(torch.abs(p_cam[..., 2]) < 1e-6, 1e-6, p_cam[..., 2])
        proj = p_cam[..., :2] / z[..., None]
        # d p_w / d(x, y, yaw) as rows, through R_wp and the projection.
        X0, X1 = P3[..., 0], P3[..., 1]
        zero = torch.zeros_like(X0 * c)
        one = torch.ones_like(zero)
        dpw = torch.stack([torch.stack([one, zero, zero], -1),
                           torch.stack([zero, one, zero], -1),
                           torch.stack([-sn * X0 - c * X1, c * X0 - sn * X1, zero], -1)],
                          -2)  # (..., h, N, 3 params, 3)
        dpc = dpw @ Rw[..., None, :, :]
        dproj = (dpc[..., :2] - proj[..., None, :] * dpc[..., 2:3]) / z[..., None, None]
        J = dproj.transpose(-1, -2) * w[..., None, None]
        return (proj - P2) * w[..., None], p_cam, J

    def irls_weights(params):
        r, _, _ = residuals(params, torch.ones_like(W))
        pn = torch.linalg.norm(r, dim=-1)
        return W * torch.clamp_max(huber / torch.clamp_min(pn, 1e-9), 1.0)

    # The yaw grid: keep the best start.
    yaws = torch.arange(yaw_candidates, dtype=torch.float32, device=points_2d.device) * (
        2.0 * math.pi / yaw_candidates)
    grid = torch.cat([xy0[..., None, :].expand(*xy0.shape[:-1], yaw_candidates, 2),
                      yaws.expand(*xy0.shape[:-1], yaw_candidates)[..., None]], -1)
    r, _, _ = residuals(grid, W)
    best_yaw = yaws[torch.argmin(torch.sum(r * r, (-1, -2)), -1)]

    # Refine the best start and its pi-mirror; keep the lower residual.
    params = torch.stack([torch.cat([xy0, best_yaw[..., None]], -1),
                          torch.cat([xy0, (best_yaw + math.pi)[..., None]], -1)], -2)
    eye3 = torch.eye(3, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        r, _, J = residuals(params, irls_weights(params))  # weights fixed in a step
        Jf = J.reshape(*J.shape[:-3], -1, 3)
        H = Jf.transpose(-1, -2) @ Jf + damping * eye3
        g = Jf.transpose(-1, -2) @ r.reshape(*r.shape[:-2], -1, 1)
        params = params - torch.linalg.solve(H, g)[..., 0]
    r, p_cam, _ = residuals(params, irls_weights(params))
    sq = torch.sum(r * r, (-1, -2))  # (..., 2)
    pick = torch.argmin(sq, -1, keepdim=True)  # (..., 1)
    params = torch.take_along_dim(params, pick[..., None], -2)[..., 0, :]
    p_cam = torch.take_along_dim(p_cam, pick[..., None, None], -3)[..., 0, :, :]
    rmse = torch.sqrt(torch.take_along_dim(sq, pick, -1)[..., 0] / wsum)

    t_w = torch.stack([params[..., 0], params[..., 1], torch.zeros_like(params[..., 0])], -1)
    R_pw = R_wp.transpose(-1, -2)
    R_cam = R_pw @ _rot_z(params[..., 2])
    t_cam = (R_pw @ (t_w - cam_pos)[..., None])[..., 0]
    cheirality = torch.mean(p_cam[..., 2] * (w_safe > 0), -1) > 0
    valid = valid & cheirality
    return PnPResult(R=torch.where(valid[..., None, None], R_cam, eye3.expand_as(R_cam)),
                     t=torch.where(valid[..., None], t_cam, torch.zeros_like(t_cam)),
                     rmse=rmse, valid=valid)
