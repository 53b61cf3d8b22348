"""Scene roster + world assembly (port of the JAX ``scene/world.py``).

The roster is host-side numpy, built exactly as the JAX package builds it
from the same (copied) asset templates. ``build_world`` composes a batch of
scene poses into flat world-frame primitive tensors with the batch
dimension written out: every per-frame tensor leads with B.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SceneConfig
from ..core import rotation
from . import assets, kinematics, taxonomy

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Roster:
    """Host-side static scene description (numpy)."""

    inst_class_id: np.ndarray  # (O,)
    inst_prim_paths: Tuple[str, ...]
    inst_class_names: Tuple[str, ...]
    inst_aabb_min: np.ndarray  # (O, 3) local
    inst_aabb_max: np.ndarray  # (O, 3)
    inst_albedo: np.ndarray  # (O, 3)
    inst_kpts: np.ndarray  # (O, K_max, 3) local, zero-padded
    inst_kpt_valid: np.ndarray  # (O, K_max) bool
    inst_kpt_channel: np.ndarray  # (O, K_max) int32, -1 pad
    inst_occlusion_group: np.ndarray  # (O,) int32
    prim_kind: np.ndarray  # (P,)
    prim_offset: np.ndarray  # (P, 3)
    prim_rot: np.ndarray  # (P, 3, 3)
    prim_params: np.ndarray  # (P, 4)
    prim_inst: np.ndarray  # (P,) instance index, -1 for ground
    crane_slice: Tuple[int, int]
    dumper_slice: Tuple[int, int]
    human_slice: Tuple[int, int]
    cone_slice: Tuple[int, int]
    tree_slice: Tuple[int, int]
    fence_slice: Tuple[int, int]
    # Device copies of the tables above, made once per device on first use.
    _device_tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                             repr=False)

    @property
    def num_instances(self) -> int:
        return int(self.inst_class_id.shape[0])

    @property
    def num_prims(self) -> int:
        return int(self.prim_kind.shape[0])

    def tensor(self, name: str, device) -> Tensor:
        """``getattr(self, name)`` as a tensor on ``device`` (cached)."""
        key = (name, str(device))
        if key not in self._device_tables:
            self._device_tables[key] = torch.as_tensor(getattr(self, name), device=device)
        return self._device_tables[key]


def _cone_path(i: int) -> str:
    return taxonomy.CONE_ROOT_PREFIX if i == 0 else f"{taxonomy.CONE_ROOT_PREFIX}_{i:02d}"


def _tree_path(i: int) -> str:
    return taxonomy.TREE_ROOT_PREFIX if i == 0 else f"{taxonomy.TREE_ROOT_PREFIX}_{i:02d}"


def _fence_path(i: int) -> str:
    return f"{taxonomy.FENCE_ROOT_PREFIX}2_{i:02d}"


def make_roster(cfg: SceneConfig = SceneConfig()) -> Roster:
    templates = assets.all_templates()
    channel_table, _ = assets.keypoint_channel_table()
    kmax = assets.MAX_KEYPOINTS_PER_OBJECT

    entries: List[Tuple[str, str]] = []  # (class_name, prim_path)
    for part in kinematics.CRANE_PART_ORDER:
        entries.append((part, taxonomy.crane_part_root(part)))
    crane_slice = (0, len(entries))
    d0 = len(entries)
    entries += [("dumper", taxonomy.DUMPER_ROOT)] * cfg.n_dumpers
    dumper_slice = (d0, len(entries))
    h0 = len(entries)
    entries += [("human", taxonomy.HUMAN_ROOT)] * cfg.n_humans
    human_slice = (h0, len(entries))
    c0 = len(entries)
    entries += [("trafficcone", _cone_path(i)) for i in range(cfg.n_cones)]
    cone_slice = (c0, len(entries))
    t0 = len(entries)
    entries += [("tree", _tree_path(i)) for i in range(cfg.n_trees)]
    tree_slice = (t0, len(entries))
    f0 = len(entries)
    entries += [("fence", _fence_path(i)) for i in range(cfg.n_fence_panels)]
    fence_slice = (f0, len(entries))

    O = len(entries)
    inst_class_id = np.zeros(O, np.int32)
    inst_aabb_min = np.zeros((O, 3), np.float32)
    inst_aabb_max = np.zeros((O, 3), np.float32)
    inst_albedo = np.zeros((O, 3), np.float32)
    inst_kpts = np.zeros((O, kmax, 3), np.float32)
    inst_kpt_valid = np.zeros((O, kmax), bool)
    inst_kpt_channel = np.full((O, kmax), -1, np.int32)

    prim_kind, prim_offset, prim_rot, prim_params, prim_inst = [], [], [], [], []
    for o, (cls, _path) in enumerate(entries):
        t = templates[cls]
        inst_class_id[o] = t.class_id
        inst_aabb_min[o] = t.aabb_min
        inst_aabb_max[o] = t.aabb_max
        inst_albedo[o] = t.albedo
        k = t.num_keypoints
        inst_kpts[o, :k] = t.keypoints
        inst_kpt_valid[o, :k] = True
        for ki in range(k):
            inst_kpt_channel[o, ki] = channel_table[(cls, ki)]
        prim_kind.append(t.prim_kind)
        prim_offset.append(t.prim_offset)
        prim_rot.append(t.prim_rot)
        prim_params.append(t.prim_params)
        prim_inst.append(np.full(t.num_prims, o, np.int32))

    occl_group = np.arange(O, dtype=np.int32)
    occl_group[crane_slice[0]:crane_slice[1]] = crane_slice[0]

    g = assets.ground_template()
    prim_kind.append(g.prim_kind)
    prim_offset.append(g.prim_offset)
    prim_rot.append(g.prim_rot)
    prim_params.append(g.prim_params)
    prim_inst.append(np.full(g.num_prims, -1, np.int32))

    return Roster(
        inst_class_id=inst_class_id,
        inst_prim_paths=tuple(p for _, p in entries),
        inst_class_names=tuple(c for c, _ in entries),
        inst_aabb_min=inst_aabb_min,
        inst_aabb_max=inst_aabb_max,
        inst_albedo=inst_albedo,
        inst_kpts=inst_kpts,
        inst_kpt_valid=inst_kpt_valid,
        inst_kpt_channel=inst_kpt_channel,
        inst_occlusion_group=occl_group,
        prim_kind=np.concatenate(prim_kind),
        prim_offset=np.concatenate(prim_offset).astype(np.float32),
        prim_rot=np.concatenate(prim_rot).astype(np.float32),
        prim_params=np.concatenate(prim_params).astype(np.float32),
        prim_inst=np.concatenate(prim_inst),
        crane_slice=crane_slice,
        dumper_slice=dumper_slice,
        human_slice=human_slice,
        cone_slice=cone_slice,
        tree_slice=tree_slice,
        fence_slice=fence_slice,
    )


class ScenePose(NamedTuple):
    """Per-frame scene parameters; every field leads with the batch dim.

    ``positions``/``yaw_deg`` cover non-crane instances by roster index (the
    crane rows are ignored: crane root pose + joints expand to the 4 part
    instances in ``instance_poses``). ``human_joints`` holds articulated COCO
    joints in each human's local frame; None means the canonical pose."""

    crane_pos: Tensor  # (B, 3)
    crane_yaw_deg: Tensor  # (B,)
    crane_joints: Tensor  # (B, 3)
    positions: Tensor  # (B, O, 3)
    yaw_deg: Tensor  # (B, O)
    human_joints: Optional[Tensor] = None  # (B, n_humans, 17, 3)

    def index(self, idx: Tensor) -> "ScenePose":
        """Rows ``idx`` of every field (the scene-cadence gather)."""
        return ScenePose(*(None if f is None else f[idx] for f in self))


def fence_default_yaw_deg(n_panels: int) -> np.ndarray:
    """Static fence-panel yaws: sides 0/1 run along x (0 deg), sides 2/3
    along y (90 deg). Shared contract with the sweep's axis-aligned
    category (render/raycast._transform_categories)."""
    per_side = max(n_panels // 4, 1)
    side = np.arange(n_panels) // per_side
    return np.where(side <= 1, 0.0, 90.0).astype(np.float32)


def default_layout(roster: Roster, cfg: SceneConfig = SceneConfig()):
    """The unrandomized positions (O, 3) and yaws (O,) as numpy: dumper at
    its reference spot, cones on a ring, trees outside the fence, the fence
    perimeter."""
    O = roster.num_instances
    positions = np.zeros((O, 3), np.float32)
    yaw = np.zeros(O, np.float32)
    d0, d1 = roster.dumper_slice
    positions[d0:d1] = [-7.37, -0.59, 0.0]
    h0, h1 = roster.human_slice
    positions[h0:h1] = [3.0, 3.0, 0.0]
    c0, c1 = roster.cone_slice
    for j, i in enumerate(range(c0, c1)):
        ang = 2 * np.pi * j / max(c1 - c0, 1)
        positions[i] = [4.0 * np.cos(ang), 4.0 * np.sin(ang), 0.0]
    t0, t1 = roster.tree_slice
    for j, i in enumerate(range(t0, t1)):
        ang = 2 * np.pi * j / max(t1 - t0, 1) + 0.3
        positions[i] = [cfg.tree_ring_radius * np.cos(ang),
                        cfg.tree_ring_radius * np.sin(ang), 0.0]
    f0, f1 = roster.fence_slice
    per_side = max((f1 - f0) // 4, 1)
    fence_yaw = fence_default_yaw_deg(f1 - f0)
    span_x = np.linspace(-cfg.fence_half_x + 1.75, cfg.fence_half_x - 1.75, per_side)
    span_y = np.linspace(-cfg.fence_half_y + 1.75, cfg.fence_half_y - 1.75, per_side)
    for j, i in enumerate(range(f0, f1)):
        side, k = j // per_side, j % per_side
        yaw[i] = fence_yaw[j]
        positions[i] = ([span_x[k], -cfg.fence_half_y, 0.0] if side == 0
                        else [span_x[k], cfg.fence_half_y, 0.0] if side == 1
                        else [-cfg.fence_half_x, span_y[k], 0.0] if side == 2
                        else [cfg.fence_half_x, span_y[k], 0.0])
    return positions, yaw


def instance_poses(roster: Roster, pose: ScenePose) -> Tuple[Tensor, Tensor]:
    """(inst_rot (B, O, 3, 3), inst_pos (B, O, 3)), the crane chain
    expanded into its 4 part rows (always the first roster rows)."""
    R_all = rotation.matrix_rot_z_degrees(pose.yaw_deg)
    crane_R = rotation.matrix_rot_z_degrees(pose.crane_yaw_deg)  # (B, 3, 3)
    fk = kinematics.crane_fk(pose.crane_joints)
    part_R, part_t = [], []
    for part in kinematics.CRANE_PART_ORDER:
        Rl, tl = fk[part]
        part_R.append(crane_R @ Rl)
        part_t.append(pose.crane_pos + torch.einsum("bij,bj->bi", crane_R, tl))
    n = len(kinematics.CRANE_PART_ORDER)
    inst_rot = torch.cat([torch.stack(part_R, dim=1), R_all[:, n:]], dim=1)
    inst_pos = torch.cat([torch.stack(part_t, dim=1), pose.positions[:, n:]], dim=1)
    return inst_rot, inst_pos


def build_world(roster: Roster, pose: ScenePose) -> Dict[str, Tensor]:
    """Flatten a batch of instance poses into world-frame primitive tensors:
    prim_rot (B, P, 3, 3), prim_pos (B, P, 3), prim_params (P, 4),
    prim_inst (P,), inst_rot (B, O, 3, 3), inst_pos (B, O, 3),
    kpts_local (B, O, K, 3)."""
    dev = pose.positions.device
    B = pose.positions.shape[0]
    inst_rot, inst_pos = instance_poses(roster, pose)
    prim_inst = roster.tensor("prim_inst", dev).long()
    is_ground = (prim_inst < 0)[None, :]
    safe_inst = torch.clamp_min(prim_inst, 0)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    pi_rot = torch.where(is_ground[..., None, None], eye, inst_rot[:, safe_inst])
    pi_pos = torch.where(is_ground[..., None], 0.0, inst_pos[:, safe_inst])

    local_rot = roster.tensor("prim_rot", dev).expand(B, -1, -1, -1)
    local_off = roster.tensor("prim_offset", dev).expand(B, -1, -1)
    kpts_local = roster.tensor("inst_kpts", dev).expand(B, -1, -1, -1)

    # Articulated workers: the posed skeleton replaces the humans' prim-local
    # transforms and keypoints (capsule params are pose-invariant).
    h0, h1 = roster.human_slice
    if pose.human_joints is not None and h1 > h0:
        hp_idx = np.nonzero((roster.prim_inst >= h0) & (roster.prim_inst < h1))[0]
        hp_idx = torch.as_tensor(hp_idx, device=dev)
        posed_rot, posed_off = kinematics.human_capsule_transforms(pose.human_joints)
        local_rot = local_rot.clone()
        local_off = local_off.clone()
        kpts_local = kpts_local.clone()
        local_rot[:, hp_idx] = posed_rot.reshape(B, -1, 3, 3)
        local_off[:, hp_idx] = posed_off.reshape(B, -1, 3)
        kpts_local[:, h0:h1, : pose.human_joints.shape[-2]] = pose.human_joints

    prim_rot = torch.einsum("bpij,bpjk->bpik", pi_rot, local_rot)
    prim_pos = pi_pos + torch.einsum("bpij,bpj->bpi", pi_rot, local_off)
    return {
        "prim_rot": prim_rot,
        "prim_pos": prim_pos,
        "prim_params": roster.tensor("prim_params", dev),
        "prim_inst": prim_inst,
        "inst_rot": inst_rot,
        "inst_pos": inst_pos,
        "kpts_local": kpts_local,
    }


def world_keypoints(inst_rot: Tensor, inst_pos: Tensor, kpts_local: Tensor) -> Tensor:
    """Object-local keypoints (B, O, K, 3) -> world frame (B, O, K, 3)."""
    return torch.einsum("boij,bokj->boki", inst_rot, kpts_local) + inst_pos[:, :, None, :]
