"""Sequence mode: temporally coherent clips instead of i.i.d. frames (port
of the JAX ``sample/sequence.py``), batched over frames.

Each clip samples two endpoint scenes: A with the reference placement
procedure (``placement.randomize_scene``), B re-running only the animated
samplers against A's placed statics (``placement.resample_animated``).
Over the clip the crane's joints and the workers' roots, yaws and joints
move between them on a smoothstep; every other instance keeps A's
placement, so the sampled collision guarantees hold at every t. The
camera flies a smoothstep path from a DR viewpoint, bounded to 30 deg of
orbit, 4 m of distance and 1 m of height over the clip.

Draws are arguments, as in ``placement``: the endpoints' uniforms come
from ``placement.scene_draws`` and ``resample_draws``, the camera's from
``camera_sampler.camera_draws`` plus 5 uniforms in [-1, 1).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..config import CameraConfig, RandomizationConfig, SceneConfig
from ..scene import world as world_mod
from . import placement

Tensor = torch.Tensor


def smoothstep(t: Tensor) -> Tensor:
    """C1 ease-in/out on [0, 1]: zero velocity at a clip's ends."""
    t = torch.clamp(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def lerp_angle_deg(a: Tensor, b: Tensor, t: Tensor) -> Tensor:
    """Shortest-path angular interpolation in degrees."""
    d = torch.remainder(b - a + 180.0, 360.0) - 180.0
    return a + d * t


def interpolate_pose(pa: world_mod.ScenePose, pb: world_mod.ScenePose, t: Tensor,
                     roster: world_mod.Roster) -> world_mod.ScenePose:
    """The animated degrees of freedom of endpoints ``pa`` and ``pb`` (leading
    F, one row a frame) at time fractions ``t`` (F,): the crane's joints and
    the workers' roots, yaws and joints; everything else keeps ``pa``'s."""
    s = smoothstep(t)
    ja, jb = pa.crane_joints, pb.crane_joints
    joints = torch.stack([
        lerp_angle_deg(ja[..., 0], jb[..., 0], s),
        ja[..., 1] + (jb[..., 1] - ja[..., 1]) * s,
        ja[..., 2] + (jb[..., 2] - ja[..., 2]) * s,
    ], dim=-1)
    positions, yaw = pa.positions, pa.yaw_deg
    h0, h1 = roster.human_slice
    if h1 > h0:
        positions, yaw = positions.clone(), yaw.clone()
        positions[:, h0:h1] = (pa.positions[:, h0:h1]
                               + (pb.positions[:, h0:h1] - pa.positions[:, h0:h1])
                               * s[:, None, None])
        yaw[:, h0:h1] = lerp_angle_deg(pa.yaw_deg[:, h0:h1], pb.yaw_deg[:, h0:h1], s[:, None])
    human_joints = pa.human_joints
    if human_joints is not None:
        human_joints = (pa.human_joints
                        + (pb.human_joints - pa.human_joints) * s[:, None, None, None])
    return world_mod.ScenePose(
        crane_pos=pa.crane_pos,
        crane_yaw_deg=pa.crane_yaw_deg,
        crane_joints=joints,
        positions=positions,
        yaw_deg=yaw,
        human_joints=human_joints,
    )


def sequence_endpoints(draws_a: Dict[str, Tensor], draws_b: Dict[str, Tensor], roster,
                       scene_cfg: SceneConfig = SceneConfig(),
                       rand_cfg: RandomizationConfig = RandomizationConfig()
                       ) -> Tuple[world_mod.ScenePose, world_mod.ScenePose]:
    """Two endpoint scenes per clip, over C clips: A from ``draws_a``
    (``scene_draws`` stacked), B from ``draws_b`` (``resample_draws``
    stacked) against A's placed statics. The port of the JAX
    ``sample_sequence_endpoints`` with its key split into the two draws."""
    pa, da = placement.randomize_scene(draws_a, roster, scene_cfg, rand_cfg,
                                       articulate_crane=True)
    pb, _ = placement.resample_animated(draws_b, roster, scene_cfg, rand_cfg, pa, da)
    return pa, pb


def sequence_camera(cam0: Tensor, tgt0: Tensor, delta: Tensor, t: Tensor,
                    cfg: CameraConfig = CameraConfig()) -> Tuple[Tensor, Tensor]:
    """Smoothstep camera flight: (cam_pos (F, 3), target (F, 3)) at ``t``
    (F,). Endpoint A is the DR viewpoint ``cam0``, ``tgt0`` (F, 3); B
    perturbs it by ``delta`` (F, 5) uniforms in [-1, 1): orbit angle (up to
    30 deg), distance (4 m), height (1 m), target x and y (2 m)."""
    d_ang, d_dist, d_h, d_tx, d_ty = delta.unbind(-1)
    ang0 = torch.atan2(cam0[:, 1], cam0[:, 0])
    r0 = torch.linalg.norm(cam0[:, :2], dim=-1)
    s = smoothstep(t)
    ang = ang0 + math.radians(30.0) * d_ang * s
    r = torch.clamp(r0 + 4.0 * d_dist * s, cfg.distance_range[0], cfg.distance_range[1])
    h = torch.clamp(cam0[:, 2] + 1.0 * d_h * s, cfg.height_range[0], cfg.height_range[1])
    cam = torch.stack([r * torch.cos(ang), r * torch.sin(ang), h], dim=-1)
    tgt = torch.stack([tgt0[:, 0] + 2.0 * d_tx * s, tgt0[:, 1] + 2.0 * d_ty * s, h], dim=-1)
    return cam, tgt
