"""Pose / bounding-box transforms on tensors (port of the JAX
``core/transforms.py``): ``bbox_record_to_pose`` is the reference's
``bboxDict_to_transform`` — local AABB corners plus a row-major
local-to-world 4x4 become (world centre, world size, extrinsic-xyz euler
degrees), the rotation orthonormalized and per-axis scale taken from the
column norms."""

from __future__ import annotations

import torch

from . import rotation

Tensor = torch.Tensor


def make_transform(R: Tensor, t: Tensor, scale: Tensor | None = None) -> Tensor:
    """(..., 4, 4) column-vector local-to-world transform; ``scale`` (..., 3)
    scales the linear block's columns per local axis (the layout
    ``bbox_record_to_pose`` decomposes: column norms = scale)."""
    lin = R if scale is None else R * scale[..., None, :]
    batch = torch.broadcast_shapes(lin.shape[:-2], t.shape[:-1])
    lin = lin.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([lin, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=lin.dtype, device=lin.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def bbox_record_to_pose(corner_min: Tensor, corner_max: Tensor,
                        transform_rowmajor: Tensor):
    """(local AABB corners, row-major 4x4) -> (centre (..., 3),
    size (..., 3), euler degrees (..., 3))."""
    T = torch.swapaxes(transform_rowmajor, -1, -2)
    center_local = 0.5 * (corner_min + corner_max)
    center_world = (torch.einsum("...ij,...j->...i", T[..., :3, :3],
                                 center_local.expand(T.shape[:-2] + (3,)))
                    + T[..., :3, 3])
    rot_mtx = T[..., :3, :3]
    euler_deg = rotation.euler_xyz_degrees_from_matrix(rotation.orthonormalize(rot_mtx))
    scale = torch.linalg.norm(rot_mtx, dim=-2)  # column norms
    size_world = scale * torch.abs(corner_max - corner_min)
    return center_world, size_world, euler_deg


