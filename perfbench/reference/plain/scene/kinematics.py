"""Articulation on tensors (port of the JAX ``scene/kinematics.py``): the
crane's kinematic chain and the articulated worker rig.

Chain, crane-root local frame: base fixed; column yaws about +Z on the base
top; boom pitches about the column's -Y at the column top; telescopic
slides out of the boom tip along the boom's +X.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import rotation
from . import assets

Tensor = torch.Tensor

BASE_TOP_Z = 0.5
COLUMN_HEIGHT = 1.5
BOOM_LENGTH = 4.0
TELE_MAX_EXT = 2.0
TELE_NESTED_OFFSET = 2.0

# [column_yaw_deg, boom_pitch_deg (positive = raised), telescopic_extension_m]
DEFAULT_CRANE_JOINTS = np.array([0.0, 40.0, 1.0], np.float32)
CRANE_JOINT_LOW = np.array([-180.0, 10.0, 0.0], np.float32)
CRANE_JOINT_HIGH = np.array([180.0, 75.0, TELE_MAX_EXT], np.float32)

CRANE_PART_ORDER = ("cranebase", "cranecolumn", "craneboom", "cranetelescopic")

# [l_arm_swing, l_arm_abduct, l_elbow, r_arm_swing, r_arm_abduct, r_elbow,
#  l_leg_swing, l_knee, r_leg_swing, r_knee]  (degrees)
HUMAN_POSE_LOW = np.array([-40.0, -10.0, 0.0, -40.0, -10.0, 0.0,
                           -25.0, 0.0, -25.0, 0.0], np.float32)
HUMAN_POSE_HIGH = np.array([40.0, 70.0, 80.0, 40.0, 70.0, 80.0,
                            25.0, 50.0, 25.0, 50.0], np.float32)


def crane_fk(joints: Tensor) -> Dict[str, Tuple[Tensor, Tensor]]:
    """joints (..., 3) -> {part: (R (..., 3, 3), t (..., 3))} in the crane
    root frame."""
    yaw, pitch, ext = joints[..., 0], joints[..., 1], joints[..., 2]
    eye = torch.eye(3, dtype=joints.dtype, device=joints.device).expand(yaw.shape + (3, 3))
    zero = torch.zeros(yaw.shape + (3,), dtype=joints.dtype, device=joints.device)

    R_col = rotation.matrix_rot_z_degrees(yaw)
    t_col = zero.clone()
    t_col[..., 2] = BASE_TOP_Z
    R_boom = R_col @ rotation.matrix_rot_y_degrees(-pitch)
    t_boom = zero.clone()
    t_boom[..., 2] = BASE_TOP_Z + COLUMN_HEIGHT
    slide = BOOM_LENGTH - TELE_NESTED_OFFSET + ext
    t_tele = t_boom + R_boom[..., :, 0] * slide[..., None]
    return {
        "cranebase": (eye, zero),
        "cranecolumn": (R_col, t_col),
        "craneboom": (R_boom, t_boom),
        "cranetelescopic": (R_boom, t_tele),
    }


def crane_reach_xy(joints: Tensor) -> Tensor:
    """Horizontal reach of the telescopic tip from the crane root."""
    pitch = torch.deg2rad(joints[..., 1])
    tip = BOOM_LENGTH - TELE_NESTED_OFFSET + joints[..., 2] + 3.0
    return tip * torch.cos(pitch)


def sample_human_pose(u: Tensor) -> Tensor:
    """Uniforms in [0, 1) (..., 10) -> working-pose joint angles in degrees."""
    low = torch.as_tensor(HUMAN_POSE_LOW, device=u.device)
    high = torch.as_tensor(HUMAN_POSE_HIGH, device=u.device)
    return low + u * (high - low)


def _rot_about(point: Tensor, pivot: Tensor, R: Tensor) -> Tensor:
    return pivot + torch.einsum("...ij,...j->...i", R, point - pivot)


def pose_human_joints(canonical_kpts: Tensor, angles_deg: Tensor) -> Tensor:
    """Articulate the canonical COCO skeleton (17, 3) by angles (..., 10)
    -> posed joints (..., 17, 3) in the human's local frame."""
    out = canonical_kpts.expand(angles_deg.shape[:-1] + (17, 3)).clone()
    a = angles_deg
    for sh, el, wr, a_sw, a_ab, a_el, side in (
        (5, 7, 9, a[..., 0], a[..., 1], a[..., 2], 1.0),
        (6, 8, 10, a[..., 3], a[..., 4], a[..., 5], -1.0),
    ):
        R_sh = rotation.matrix_rot_y_degrees(a_sw) @ rotation.matrix_rot_x_degrees(-side * a_ab)
        elbow = _rot_about(out[..., el, :], out[..., sh, :], R_sh)
        wrist0 = _rot_about(out[..., wr, :], out[..., sh, :], R_sh)
        wrist = _rot_about(wrist0, elbow, rotation.matrix_rot_y_degrees(-a_el))
        out[..., el, :] = elbow
        out[..., wr, :] = wrist
    for hp, kn, an, a_sw, a_kn in (
        (11, 13, 15, a[..., 6], a[..., 7]),
        (12, 14, 16, a[..., 8], a[..., 9]),
    ):
        R_hip = rotation.matrix_rot_y_degrees(a_sw)
        knee = _rot_about(out[..., kn, :], out[..., hp, :], R_hip)
        ankle0 = _rot_about(out[..., an, :], out[..., hp, :], R_hip)
        ankle = _rot_about(ankle0, knee, rotation.matrix_rot_y_degrees(a_kn))
        out[..., kn, :] = knee
        out[..., an, :] = ankle
    return out


def _frame_from_z(z: Tensor) -> Tensor:
    """Rotation (..., 3, 3) whose +Z column is the direction of z."""
    zn = z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-6)
    x_axis = torch.zeros_like(zn)
    x_axis[..., 0] = 1.0
    z_axis = torch.zeros_like(zn)
    z_axis[..., 2] = 1.0
    up = torch.where(torch.abs(zn[..., 2:3]) > 0.9, x_axis, z_axis)
    x = torch.linalg.cross(up, zn, dim=-1)
    x = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-6)
    y = torch.linalg.cross(zn, x, dim=-1)
    return torch.stack([x, y, zn], dim=-1)


def human_capsule_transforms(joints: Tensor):
    """Posed joints (..., 17, 3) -> (rot (..., P_h, 3, 3), offset (..., P_h, 3))
    for the human template's primitives in template order: head sphere,
    torso capsule, then ``assets.HUMAN_SEGMENTS``."""
    j = joints
    head = (j[..., 0, :] + j[..., 3, :] + j[..., 4, :]) / 3.0
    head = head + torch.tensor([0.0, 0.0, 0.04], dtype=j.dtype, device=j.device)
    eye = torch.eye(3, dtype=j.dtype, device=j.device).expand(head.shape[:-1] + (3, 3))
    mid_sh = (j[..., 5, :] + j[..., 6, :]) / 2.0
    mid_hip = (j[..., 11, :] + j[..., 12, :]) / 2.0
    rots = [eye, _frame_from_z(mid_hip - mid_sh)]
    offs = [head, (mid_sh + mid_hip) / 2.0]
    for a, b, _r in assets.HUMAN_SEGMENTS:
        rots.append(_frame_from_z(j[..., b, :] - j[..., a, :]))
        offs.append((j[..., a, :] + j[..., b, :]) / 2.0)
    return torch.stack(rots, dim=-3), torch.stack(offs, dim=-2)
