"""Convert the JAX package's state into the port's, through numpy.

This is the slice's "weights": one sampled scene, camera and light handed
to both packages. Inputs are anything ``np.asarray`` accepts (numpy or
JAX arrays), read by attribute, so this module imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .render.shading import Lighting
from .scene.world import ScenePose

ROSTER_ARRAYS = ("inst_class_id", "inst_aabb_min", "inst_aabb_max", "inst_albedo",
                 "inst_kpts", "inst_kpt_valid", "inst_kpt_channel", "inst_occlusion_group",
                 "prim_kind", "prim_offset", "prim_rot", "prim_params", "prim_inst")
ROSTER_STATIC = ("inst_prim_paths", "inst_class_names", "crane_slice", "dumper_slice",
                 "human_slice", "cone_slice", "tree_slice", "fence_slice")


def _t(x, device, batched: bool) -> torch.Tensor:
    a = np.array(x, np.float32)  # a writable copy
    return torch.as_tensor(a if batched else a[None], device=device)


def scene_pose(pose, device="cpu", batched: bool = True) -> ScenePose:
    """A JAX ``ScenePose`` (fields crane_pos, crane_yaw_deg, crane_joints,
    positions, yaw_deg, human_joints) -> the port's. ``batched=False``
    adds the leading batch dim of one frame."""
    hj = pose.human_joints
    return ScenePose(
        crane_pos=_t(pose.crane_pos, device, batched),
        crane_yaw_deg=_t(pose.crane_yaw_deg, device, batched),
        crane_joints=_t(pose.crane_joints, device, batched),
        positions=_t(pose.positions, device, batched),
        yaw_deg=_t(pose.yaw_deg, device, batched),
        human_joints=None if hj is None else _t(hj, device, batched),
    )


def cameras(cam_pos, target, device="cpu"):
    """(B, 3) camera positions and look-at targets -> tensors."""
    return _t(cam_pos, device, True), _t(target, device, True)


def lighting(lit, device="cpu", batched: bool = True) -> Lighting:
    """A JAX ``Lighting`` (scalar fields per frame) -> the port's."""
    return Lighting(*(_t(getattr(lit, f), device, batched) for f in Lighting._fields))


def roster_arrays(roster) -> Dict[str, object]:
    """A roster's tables as numpy, plus its static fields, for equality."""
    out = {k: np.asarray(getattr(roster, k)) for k in ROSTER_ARRAYS}
    out.update({k: getattr(roster, k) for k in ROSTER_STATIC})
    return out
