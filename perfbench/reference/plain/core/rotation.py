"""Batched rotation math on tensors (port of the JAX ``core/rotation.py``).

Shepperd matrix -> quaternion and back, the Hamilton product and
quaternion rotation of vectors, the extrinsic-xyz euler extraction of the
label pipeline, the Newton-polar ``orthonormalize`` and the elementary
axis rotations. Every function takes any leading batch shape.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def quat_wxyz_from_matrix(R: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) in (w, x, y, z).

    Branchless Shepperd method: all four candidates are computed and the
    numerically stable one is selected (trace > 0, else the largest
    diagonal element)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    s0 = safe_sqrt(trace + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    cond0 = (trace > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_xyzw_from_matrix(R: Tensor) -> Tensor:
    """Matrix -> quaternion in scipy (x, y, z, w) order."""
    q = quat_wxyz_from_matrix(R)
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def _axis_matrix(deg: Tensor, axis: int) -> Tensor:
    rad = torch.deg2rad(deg)
    c, s = torch.cos(rad), torch.sin(rad)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    if axis == 2:
        rows = ([c, -s, z], [s, c, z], [z, z, o])
    elif axis == 1:
        rows = ([c, z, s], [z, o, z], [-s, z, c])
    else:
        rows = ([o, z, z], [z, c, -s], [z, s, c])
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def matrix_rot_z_degrees(deg: Tensor) -> Tensor:
    """Rz(deg) (..., 3, 3): the only axis the object randomizer rotates about."""
    return _axis_matrix(deg, 2)


def matrix_rot_y_degrees(deg: Tensor) -> Tensor:
    return _axis_matrix(deg, 1)


def matrix_rot_x_degrees(deg: Tensor) -> Tensor:
    return _axis_matrix(deg, 0)


def euler_xyz_degrees_from_matrix(R: Tensor) -> Tensor:
    """Extrinsic-xyz euler angles in degrees, scipy
    ``Rotation.as_euler('xyz', degrees=True)`` semantics; gimbal lock sets
    the third angle to zero as scipy does."""
    r20 = torch.clamp(R[..., 2, 0], -1.0, 1.0)
    b = -torch.asin(r20)
    a = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    c = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    gimbal = torch.abs(r20) > 1.0 - 1e-7
    a_lock = torch.atan2(-R[..., 1, 2], R[..., 1, 1])
    a = torch.where(gimbal, a_lock, a)
    c = torch.where(gimbal, torch.zeros_like(c), c)
    return torch.rad2deg(torch.stack([a, b, c], dim=-1))


def orthonormalize(M: Tensor) -> Tensor:
    """Closest orthonormal matrix (the polar factor U @ Vt of the SVD) by
    five determinant-scaled Newton polar steps on the nine component planes,
    as the JAX reference does: X <- (g X + (g X)^-T) / 2, g = |det X|^(-1/3),
    with (g X)^-T = cof(X) / (g det X)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    for _ in range(5):
        ca, cb, cc = e * i - f * h, f * g - d * i, d * h - e * g
        cd, ce, cf = c * h - b * i, a * i - c * g, b * g - a * h
        cg, ch, ci = b * f - c * e, c * d - a * f, a * e - b * d
        det = a * ca + b * cb + c * cc
        tiny = torch.where(det < 0, torch.full_like(det, -1e-20), torch.full_like(det, 1e-20))
        det = torch.where(torch.abs(det) < 1e-20, tiny, det)
        s = torch.pow(1.0 / torch.abs(det), 1.0 / 3.0)
        w = 0.5 / (s * det)
        s = 0.5 * s
        a, b, c = s * a + w * ca, s * b + w * cb, s * c + w * cc
        d, e, f = s * d + w * cd, s * e + w * ce, s * f + w * cf
        g, h, i = s * g + w * cg, s * h + w * ch, s * i + w * ci
    rows = (torch.stack([a, b, c], -1), torch.stack([d, e, f], -1),
            torch.stack([g, h, i], -1))
    return torch.stack(rows, -2)
