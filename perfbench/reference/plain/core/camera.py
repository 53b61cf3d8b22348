"""Batched camera model on tensors (port of the JAX ``core/camera.py``).

Conventions are the reference's (see the JAX module): the camera looks along
its -X axis with +Z up, ``look_at_matrix`` is the det=-1 ``camPosOri`` frame,
and ``R_PINHOLE_FROM_CAM`` maps camera-frame coordinates to the pinhole frame
(X right, Y down, Z forward). ``R_PINHOLE_FROM_CAM`` is a signed permutation,
so every product with it below is written out as the exact component
shuffle it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rotation

Tensor = torch.Tensor

R_PINHOLE_FROM_CAM = np.array(
    [
        [0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0],
        [-1.0, 0.0, 0.0],
    ]
)

CLIPPING_RANGE = (0.5, 250.0)


class Intrinsics(NamedTuple):
    """Pinhole intrinsics; the four scalars are float32 values held as
    Python floats, so kernels and tensors see the same numbers."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def intrinsics_from_apertures(focal_length: float, horizontal_aperture: float,
                              width: int, height: int,
                              vertical_aperture: float | None = None) -> Intrinsics:
    """``fx = W f / h_ap``, ``fy = H f / v_ap`` with ``v_ap = h_ap H / W``
    (so fx == fy), principal point at the image centre; float32 arithmetic
    as in the JAX reference."""
    f32 = np.float32
    fl = f32(focal_length)
    ha = f32(horizontal_aperture)
    va = ha * f32(height / width) if vertical_aperture is None else f32(vertical_aperture)
    fx = f32(f32(width) * fl) / ha
    fy = f32(f32(height) * fl) / va
    return Intrinsics(fx=float(fx), fy=float(fy), cx=float(f32(width / 2.0)),
                      cy=float(f32(height / 2.0)), width=width, height=height)


def look_at_matrix(cam_pos: Tensor, target: Tensor) -> Tensor:
    """``camPosOri`` frame (..., 3, 3): columns [-forward | -right | up],
    with the reference's +X fallback when forward is parallel to world up."""
    forward = target - cam_pos
    forward = forward / torch.linalg.norm(forward, dim=-1, keepdim=True)
    world_up = torch.zeros_like(forward)
    world_up[..., 2] = 1.0
    right = torch.linalg.cross(forward, world_up, dim=-1)
    right_norm = torch.linalg.norm(right, dim=-1, keepdim=True)
    fallback = torch.zeros_like(forward)
    fallback[..., 0] = 1.0
    right = torch.where(right_norm < 1e-6, fallback,
                        right / torch.clamp_min(right_norm, 1e-12))
    up = torch.linalg.cross(right, forward, dim=-1)
    up = up / torch.linalg.norm(up, dim=-1, keepdim=True)
    return torch.stack([-forward, -right, up], dim=-1)


def pinhole_basis(M: Tensor) -> Tensor:
    """``M @ R_PINHOLE_FROM_CAM^T``: the columns (-M[:, 1], -M[:, 2], -M[:, 0])."""
    return torch.stack([-M[..., 1], -M[..., 2], -M[..., 0]], dim=-1)


def world_from_pinhole_matrix(cam_pos: Tensor, target: Tensor) -> Tensor:
    """Proper rotation pinhole -> world: the pinhole basis of the look-at
    frame."""
    return pinhole_basis(look_at_matrix(cam_pos, target))


def ray_params(M: Tensor, cam_pos: Tensor, intr: Intrinsics) -> Tensor:
    """(B, 16) per-frame scalars from which the CUDA kernels rebuild every
    pixel ray: the pinhole basis row-major (9), cx, cy, fx, fy, camera
    position (3)."""
    B = M.shape[0]
    intr4 = torch.tensor([intr.cx, intr.cy, intr.fx, intr.fy], device=M.device).expand(B, 4)
    return torch.cat([pinhole_basis(M).reshape(B, 9), intr4, cam_pos], dim=1)


def camera_pose7_xyzw(cam_pos: Tensor, target: Tensor,
                      bug_compatible: bool = False) -> Tensor:
    """[x, y, z, qx, qy, qz, qw]. ``bug_compatible`` emits the reference's
    Shepperd-of-reflection quaternion of the det=-1 frame."""
    if bug_compatible:
        q = rotation.quat_wxyz_from_matrix(look_at_matrix(cam_pos, target))
        q_xyzw = torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)
    else:
        q_xyzw = rotation.quat_xyzw_from_matrix(world_from_pinhole_matrix(cam_pos, target))
    return torch.cat([cam_pos, q_xyzw], dim=-1)


def world_to_pinhole(points_w: Tensor, cam_pos: Tensor, R_cam2world: Tensor) -> Tensor:
    """World points (B, N, 3) -> pinhole coordinates (B, N, 3)."""
    rel = points_w - cam_pos[:, None, :]
    cam = torch.einsum("bji,bnj->bni", R_cam2world, rel)  # R^T rel
    return torch.stack([-cam[..., 1], -cam[..., 2], -cam[..., 0]], dim=-1)


def project(points_w: Tensor, cam_pos: Tensor, R_cam2world: Tensor, intr: Intrinsics):
    """World points (B, N, 3) -> (uv (B, N, 2), pinhole depth z (B, N))."""
    pin = world_to_pinhole(points_w, cam_pos, R_cam2world)
    z = pin[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = intr.fx * pin[..., 0] / z_safe + intr.cx
    v = intr.fy * pin[..., 1] / z_safe + intr.cy
    return torch.stack([u, v], dim=-1), z


def pixel_rays(intr: Intrinsics, R_cam2world: Tensor) -> Tensor:
    """Unit world ray through every integer pixel: (B, H, W, 3).

    Pinhole direction (x, y, 1) is (-1, -x, -y) in the camera frame, then
    rotated by ``R_cam2world`` (B, 3, 3) and divided by its norm."""
    dev = R_cam2world.device
    u = torch.arange(intr.width, dtype=torch.float32, device=dev)
    v = torch.arange(intr.height, dtype=torch.float32, device=dev)
    x = ((u - intr.cx) / intr.fx)[None, :].expand(intr.height, -1)
    y = ((v - intr.cy) / intr.fy)[:, None].expand(-1, intr.width)
    M = R_cam2world[:, None, None]  # (B, 1, 1, 3, 3)
    c0, c1, c2 = -1.0, -x, -y
    dirs = torch.stack(
        [M[..., i, 0] * c0 + M[..., i, 1] * c1 + M[..., i, 2] * c2 for i in range(3)],
        dim=-1)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def depth_valid_mask(depth: Tensor, far: float = CLIPPING_RANGE[1]) -> Tensor:
    """Finite, > 0 and < the far clip (the reference's validity rule)."""
    return torch.isfinite(depth) & (depth > 0) & (depth < far)
