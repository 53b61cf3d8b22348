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

* ``solve_pnp_ransac``: minimal DLT solves on Gumbel-top-k subsets, all
  hypotheses at once, then ``solve_pnp`` on the best consensus set.
* ``solve_crane_pose``: the crane's five joint parameters under its
  kinematic chain, from a (yaw, pitch) grid through batched
  Levenberg-Marquardt from the best 8 starts.

All run in f32 with TF32 off in matmuls and convolutions for their whole
duration, whatever the caller set (``_pin_highest``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..scene import kinematics

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


def gumbel(shape, generator: Optional[torch.Generator] = None, device="cpu") -> Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u in [tiny, 1) as
    ``jax.random.gumbel`` makes them, from a CPU ``generator`` (a new one
    seeded 0 when none is given), moved to ``device``."""
    generator = generator or torch.Generator().manual_seed(0)
    u = torch.clamp_min(torch.rand(shape, generator=generator), torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def ransac_consensus(points_3d: Tensor, points_2d: Tensor, weights: Tensor, scores: Tensor,
                     subset: int = 6, inlier_thresh: float = 0.01):
    """The hypotheses of ``solve_pnp_ransac`` and their consensus: the
    ``subset`` highest ``scores`` (..., H, N) among the usable points pick
    each hypothesis's points (ties to the lower index, as ``lax.top_k``),
    a DLT solves each, and a point is an inlier of a hypothesis within
    ``inlier_thresh`` of its reprojection and in front of the camera.
    Returns (best (...,), its inliers (..., N) bool), the first
    hypothesis of the largest consensus."""
    usable = weights > 0
    H, N = scores.shape[-2:]
    g = torch.where(usable[..., None, :], scores, float("-inf"))
    idx = torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :subset]
    lead = idx.shape[:-2]
    X = torch.take_along_dim(points_3d[..., None, :, :].expand(*lead, H, N, 3),
                             idx[..., None], -2)
    x = torch.take_along_dim(points_2d[..., None, :, :].expand(*lead, H, N, 2),
                             idx[..., None], -2)
    R_h, t_h = dlt_init(X, x, torch.ones_like(x[..., 0]))  # (..., H, 3, 3), (..., H, 3)
    proj, p_cam = _project(R_h, t_h, points_3d[..., None, :, :].expand(*lead, H, N, 3))
    err = torch.linalg.norm(proj - points_2d[..., None, :, :], dim=-1)  # (..., H, N)
    inlier = (err <= inlier_thresh) & usable[..., None, :] & (p_cam[..., 2] > 0)
    best = torch.argmax(torch.sum(inlier, -1), -1)
    return best, torch.take_along_dim(inlier, best[..., None, None], -2)[..., 0, :]


@_pin_highest
def solve_pnp_ransac(points_3d: Tensor, points_2d: Tensor, weights: Tensor,
                     scores: Optional[Tensor] = None,
                     generator: Optional[torch.Generator] = None, hypotheses: int = 32,
                     subset: int = 6, inlier_thresh: float = 0.01, iters: int = 8,
                     min_points: int = 6) -> PnPResult:
    """Robust PnP over leading batch dims: ``hypotheses`` minimal DLT
    subsets drawn by Gumbel top-k over the usable points, batched; the
    best consensus set's inliers (all usable points when it holds fewer
    than ``subset``) drive the final ``solve_pnp``. ``scores`` (..., H, N)
    are the Gumbel draws; without them they are drawn from ``generator``
    (``gumbel``)."""
    if scores is None:
        scores = gumbel(weights.shape[:-1] + (hypotheses, points_3d.shape[-2]), generator,
                        weights.device)
    _, inliers = ransac_consensus(points_3d, points_2d, weights, scores, subset, inlier_thresh)
    enough = torch.sum(inliers, -1) >= subset
    w_final = torch.where(enough[..., None], inliers.to(weights.dtype) * weights, weights)
    return solve_pnp(points_3d, points_2d, w_final, iters=iters, min_points=min_points)


CRANE_STARTS = 8  # LM starts refined at once


class CranePnPResult(NamedTuple):
    params: Tensor  # (..., 5) [x, y, yaw_col_rad, pitch_rad, ext_m]
    R: Tensor  # (..., 4, 3, 3) per-part camera-frame rotations (CRANE_PART_ORDER)
    t: Tensor  # (..., 4, 3)
    rmse: Tensor  # (...,) weighted reprojection RMSE (normalized coords)
    valid: Tensor  # (...,) bool


def _crane_parts(params: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(..., 5) -> per-part world (R (..., 4, 3, 3), t (..., 4, 3)) and the
    column's rotation (..., 3, 3)."""
    joints = torch.stack([torch.rad2deg(params[..., 2]), torch.rad2deg(params[..., 3]),
                          params[..., 4]], -1)
    fk = kinematics.crane_fk(joints)
    R = torch.stack([fk[p][0] for p in kinematics.CRANE_PART_ORDER], -3)
    t = torch.stack([fk[p][1] for p in kinematics.CRANE_PART_ORDER], -2)
    root = torch.stack([params[..., 0], params[..., 1], torch.zeros_like(params[..., 0])], -1)
    return R, t + root[..., None, :], fk["cranecolumn"][0]


def _crane_residuals(params: Tensor, kpts_local: Tensor, P2: Tensor, W: Tensor, Rw: Tensor,
                     cp: Tensor, jacobian: bool = False):
    """params (..., 5) -> weighted residuals (..., 4, K, 2) and p_cam
    (..., 4, K, 3), and with ``jacobian`` their derivative (..., 4, K, 2, 5)
    by the chain's geometry: x and y translate every part, the column yaw
    turns every part but the base about the root's vertical, the pitch turns
    the boom and the telescopic about the pivot's horizontal axis -R_col e_y,
    the extension slides the telescopic along the boom. The observations
    P2, W, Rw, cp broadcast against params' leading dims."""
    R, t, R_col = _crane_parts(params)
    p_w = torch.einsum("...pij,pkj->...pki", R, kpts_local) + t[..., :, None, :]
    d = p_w - cp[..., None, None, :]
    p_cam = torch.einsum("...pkj,...ji->...pki", d, Rw)
    small = torch.abs(p_cam[..., 2]) < 1e-6
    z = torch.where(small, 1e-6, p_cam[..., 2])
    proj = p_cam[..., :2] / z[..., None]
    r = (proj - P2) * W[..., None]
    if not jacobian:
        return r, p_cam
    zero = torch.zeros_like(p_w[..., 0])
    one = torch.ones_like(zero)
    part = torch.arange(4, device=params.device)[:, None]  # (4, 1)
    rel = p_w - torch.stack([params[..., 0], params[..., 1], torch.zeros_like(params[..., 0])],
                            -1)[..., None, None, :]
    turns = (part >= 1).to(p_w.dtype)
    pitched = (part >= 2).to(p_w.dtype)
    d_yaw = torch.stack([-rel[..., 1], rel[..., 0], zero], -1) * turns[..., None]
    axis = -R_col[..., :, 1][..., None, None, :]  # (..., 1, 1, 3)
    pivot = torch.zeros_like(rel)
    pivot[..., 2] = kinematics.BASE_TOP_Z + kinematics.COLUMN_HEIGHT
    d_pitch = torch.linalg.cross(axis.expand_as(rel), rel - pivot, dim=-1) * pitched[..., None]
    tele = (part == 3).to(p_w.dtype)
    d_ext = R[..., :, 0][..., :, None, :].expand_as(rel) * tele[..., None]
    dpw = torch.stack([torch.stack([one, zero, zero], -1), torch.stack([zero, one, zero], -1),
                       d_yaw, d_pitch, d_ext], -1)  # (..., 4, K, 3, 5)
    dpc = torch.einsum("...ji,...pkjc->...pkic", Rw, dpw)
    dz = torch.where(small[..., None], 0.0, dpc[..., 2, :])
    dproj = (dpc[..., :2, :] - proj[..., None] * dz[..., None, :]) / z[..., None, None]
    return r, p_cam, dproj * W[..., None, None]


@_pin_highest
def solve_crane_pose(kpts_local: Tensor, points_2d: Tensor, weights: Tensor, R_wp: Tensor,
                     cam_pos: Tensor, yaw_candidates: int = 16,
                     pitch_grid: Tuple[float, ...] = (15.0, 35.0, 55.0, 75.0), iters: int = 20,
                     damping: float = 1e-4, min_points: int = 6) -> CranePnPResult:
    """FK-constrained crane pose over leading batch dims: (x, y, column
    yaw, boom pitch, telescopic extension) from the 2D keypoints of all
    four parts at once. kpts_local (4, K, 3) part-local keypoints in
    ``kinematics.CRANE_PART_ORDER``; points_2d (..., 4, K, 2) normalized;
    weights (..., 4, K); R_wp (..., 3, 3) world-from-pinhole; cam_pos
    (..., 3) world.

    Start: for each of ``yaw_candidates`` x ``pitch_grid`` articulations,
    the root xy in closed form (the weighted 2D centroid's ray dropped to
    the height of that articulation's keypoint centroid, less the
    centroid's horizontal offset); the best ``CRANE_STARTS`` (the
    near-collinear boom keypoints admit a Necker-flip basin LM cannot
    leave). Refinement: ``iters`` Levenberg-Marquardt steps on all starts
    at once, each a step clamped to the joint limits and site bounds,
    taken only if it lowers the residual (lam x 0.3, floor 1e-8), else
    lam x 5. The lowest final residual wins; cheirality gates ``valid``.
    The JAX solve's ``robust_width`` is not used by its code, so it is not
    here. Returns per-part camera-frame poses, like ``solve_pnp``."""
    lead = points_2d.shape[:-3]
    dev, dt = points_2d.device, points_2d.dtype
    kpts_local = kpts_local.to(dev, dt)
    valid = torch.sum(weights > 0, (-2, -1)) >= min_points
    w_safe = torch.where(valid[..., None, None], weights, torch.ones_like(weights))
    # The observations with a start axis before the parts.
    P2, W = points_2d.unsqueeze(-4), w_safe.unsqueeze(-3)
    Rw, cp = R_wp.unsqueeze(-3), cam_pos.unsqueeze(-2)

    wsum = torch.clamp_min(torch.sum(w_safe, (-2, -1)), 1e-9)
    uvc = torch.sum(points_2d * w_safe[..., None], (-3, -2)) / wsum[..., None]
    d_w = (R_wp @ torch.cat([uvc, torch.ones_like(uvc[..., :1])], -1)[..., None])[..., 0]
    yaws = torch.arange(yaw_candidates, dtype=dt, device=dev) * (
        2.0 * math.pi / yaw_candidates) - math.pi
    pitches = torch.deg2rad(torch.tensor(pitch_grid, dtype=dt, device=dev))
    grid = torch.stack(torch.meshgrid(yaws, pitches, indexing="ij"), -1).reshape(-1, 2)
    n_grid = grid.shape[0]
    g5 = torch.cat([torch.zeros(n_grid, 2, dtype=dt, device=dev), grid,
                    torch.ones(n_grid, 1, dtype=dt, device=dev)], -1)
    R0, t0, _ = _crane_parts(g5)
    p_root = torch.einsum("gpij,pkj->gpki", R0, kpts_local) + t0[:, :, None, :]  # (G, 4, K, 3)
    c = torch.einsum("gpkj,...pk->...gj", p_root, w_safe) / wsum[..., None, None]
    dz = torch.where(torch.abs(d_w[..., 2]) < 1e-6, 1e-6, d_w[..., 2])
    s = torch.clamp((c[..., 2] - cam_pos[..., None, 2]) / dz[..., None], 0.5, 500.0)
    xy = (cam_pos[..., None, :] + s[..., None] * d_w[..., None, :])[..., :2] - c[..., :2]
    cands = torch.cat([xy, grid.expand(*lead, n_grid, 2),
                       torch.ones(*lead, n_grid, 1, dtype=dt, device=dev)], -1)
    r, _ = _crane_residuals(cands, kpts_local, P2, W, Rw, cp)
    order = torch.sort(torch.sum(r * r, (-3, -2, -1)), dim=-1, stable=True).indices
    params = torch.take_along_dim(cands, order[..., :CRANE_STARTS, None], -2)  # (..., S, 5)

    lo = torch.tensor([-20.0, -20.0, -7.0, math.radians(5.0), -0.5], dtype=dt, device=dev)
    hi = torch.tensor([20.0, 20.0, 7.0, math.radians(85.0), 2.5], dtype=dt, device=dev)
    lam = torch.full(params.shape[:-1], damping, dtype=dt, device=dev)
    eye5 = torch.eye(5, dtype=dt, device=dev)
    for _ in range(iters):
        r, _, J = _crane_residuals(params, kpts_local, P2, W, Rw, cp, jacobian=True)
        Jf = J.reshape(*J.shape[:-4], -1, 5)
        rf = r.reshape(*r.shape[:-3], -1, 1)
        H = Jf.transpose(-1, -2) @ Jf + lam[..., None, None] * eye5
        delta = -torch.linalg.solve_ex(H, Jf.transpose(-1, -2) @ rf)[0][..., 0]
        cand = torch.minimum(torch.maximum(params + delta, lo), hi)
        r_new, _ = _crane_residuals(cand, kpts_local, P2, W, Rw, cp)
        better = torch.sum(r_new * r_new, (-3, -2, -1)) < torch.sum(r * r, (-3, -2, -1))
        params = torch.where(better[..., None], cand, params)
        lam = torch.where(better, torch.clamp_min(lam * 0.3, 1e-8), lam * 5.0)
    r, p_cam = _crane_residuals(params, kpts_local, P2, W, Rw, cp)
    sq = torch.sum(r * r, (-3, -2, -1))  # (..., S)
    best = torch.argmin(sq, -1, keepdim=True)
    params = torch.take_along_dim(params, best[..., None], -2)[..., 0, :]
    p_cam = torch.take_along_dim(p_cam, best[..., None, None, None], -4)[..., 0, :, :, :]
    rmse = torch.sqrt(torch.take_along_dim(sq, best, -1)[..., 0] / wsum)

    R_parts, t_parts, _ = _crane_parts(params)
    R_cam = torch.einsum("...ji,...pjk->...pik", R_wp, R_parts)
    t_cam = torch.einsum("...ji,...pj->...pi", R_wp, t_parts - cam_pos[..., None, :])
    valid = valid & (torch.sum(p_cam[..., 2] * (w_safe > 0), (-2, -1)) > 0)
    eye = torch.eye(3, dtype=dt, device=dev).expand_as(R_cam)
    return CranePnPResult(params=params,
                          R=torch.where(valid[..., None, None, None], R_cam, eye),
                          t=torch.where(valid[..., None, None], t_cam, torch.zeros_like(t_cam)),
                          rmse=rmse, valid=valid)
