"""Camera-viewpoint sampling (port of the JAX ``sample/camera_sampler.py``).

Two samplers: the continuous domain-randomization sampler the datagen step
uses (distance, height and angle ranges from ``CameraConfig``, horizontal
aim at a jittered scene-centre target) and the reference's systematic
three-stage ladder (key positions, rings, biased random fill), and the
reference's retry nudge of a camera position (``retry_jitter``). Random draws
come from an explicit ``torch.Generator``; the draw step and the
deterministic transform are separate so a batch can draw on the host and
transform on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import CameraConfig

Tensor = torch.Tensor

HEIGHTS = np.array([1.6, 1.7, 1.8, 2.0, 2.5, 3.0], np.float32)
DUMPER_CENTER = np.array([-7.37, -0.59], np.float32)

# (cam_xy, target_xy): the reference's key-position table.
_D = DUMPER_CENTER.tolist()
KEY_POSITIONS = np.array(
    [
        [[-15.0, -0.6], _D], [[-2.0, -0.6], _D], [[-7.4, 6.0], _D],
        [[-7.4, -7.0], _D], [[-12.0, 4.0], _D], [[-12.0, -5.0], _D],
        [[-4.0, 4.0], _D], [[-4.0, -4.0], _D], [[-10.0, 0.0], _D],
        [[-5.0, 2.0], _D], [[-5.0, -3.0], _D], [[-9.0, -4.0], _D],
        [[-3.0, -3.0], [0.0, 0.0]], [[-3.0, 3.0], [0.0, 0.0]],
        [[0.0, 0.0], [5.0, 0.0]], [[0.0, 0.0], [-5.0, 0.0]],
        [[6.0, 0.0], [0.0, 0.0]], [[0.0, 6.0], [0.0, 0.0]],
        [[0.0, -6.0], [0.0, 0.0]], [[-6.0, 0.0], [0.0, 0.0]],
        [[5.0, 5.0], [0.0, 0.0]], [[5.0, -5.0], [0.0, 0.0]],
        [[-5.0, 5.0], [0.0, 0.0]], [[-5.0, -5.0], [0.0, 0.0]],
        [[3.0, 0.0], [0.0, 0.0]], [[-3.0, 0.0], [0.0, 0.0]],
        [[0.0, 3.0], [0.0, 0.0]], [[0.0, -3.0], [0.0, 0.0]],
        [[-8.0, -3.0], [0.0, 0.0]], [[-8.0, 3.0], [0.0, 0.0]],
    ],
    np.float32,
)

RING_RADII = np.array([4.0, 6.0, 8.0, 10.0, 12.0], np.float32)
POINTS_PER_RING = 8
CAMERA_DRAWS = 5  # uniforms per DR camera: distance, height, angle, target xy


def _uniform(u: Tensor, lo, hi) -> Tensor:
    return lo + u * (hi - lo)


def camera_draws(gen: torch.Generator, n: int) -> Tensor:
    """(n, CAMERA_DRAWS) uniforms in [0, 1) for ``cameras_from_draws``."""
    return torch.rand(n, CAMERA_DRAWS, generator=gen)


def cameras_from_draws(u: Tensor, cfg: CameraConfig = CameraConfig()) -> Tuple[Tensor, Tensor]:
    """Uniforms (..., 5) -> (cam_pos (..., 3), target (..., 3))."""
    dist = _uniform(u[..., 0], *cfg.distance_range)
    height = _uniform(u[..., 1], *cfg.height_range)
    ang = torch.deg2rad(_uniform(u[..., 2], *cfg.angle_range))
    cam = torch.stack([dist * torch.cos(ang), dist * torch.sin(ang), height], dim=-1)
    tgt = torch.stack([_uniform(u[..., 3], -3.0, 3.0), _uniform(u[..., 4], -3.0, 3.0),
                       height], dim=-1)
    return cam, tgt


def mix_cameras(use_ladder, ladder_cam: Tensor, ladder_tgt: Tensor, dr_cam: Tensor,
                dr_tgt: Tensor) -> Tuple[Tensor, Tensor]:
    """Per frame, the ladder view where ``use_ladder`` (B,) bool holds, else
    the DR view; ``use_ladder=None`` takes the ladder everywhere."""
    if use_ladder is None:
        return ladder_cam, ladder_tgt
    u = use_ladder[:, None]
    return torch.where(u, ladder_cam, dr_cam), torch.where(u, ladder_tgt, dr_tgt)


def systematic_camera_positions(num_frames: int, gen: torch.Generator) -> Tuple[Tensor, Tensor]:
    """(cam_positions (N, 3), targets (N, 3)) with the reference ladder's
    semantics: key positions, then 5 rings of 8 points (40% of targets
    jittered about the dumper), then a biased random fill (50% near the
    dumper). Heights cycle ``HEIGHTS``; targets aim level."""
    n_keys = min(num_frames, len(KEY_POSITIONS))
    cams = [torch.as_tensor(KEY_POSITIONS[:n_keys, 0])]
    tgts = [torch.as_tensor(KEY_POSITIONS[:n_keys, 1])]
    remaining = num_frames - n_keys
    dumper = torch.as_tensor(DUMPER_CENTER)
    if remaining > 0:
        ang = 2 * np.pi * np.arange(POINTS_PER_RING) / POINTS_PER_RING
        ring_xy = np.concatenate([np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
                                  for r in RING_RADII]).astype(np.float32)
        n_ring = min(remaining, len(ring_xy))
        bias = torch.rand(n_ring, generator=gen) < 0.4
        jit_xy = _uniform(torch.rand(n_ring, 2, generator=gen), -2.0, 2.0)
        cams.append(torch.as_tensor(ring_xy[:n_ring]))
        tgts.append(torch.where(bias[:, None], dumper + jit_xy, 0.0))
        remaining -= n_ring
        if remaining > 0:
            near = torch.rand(remaining, generator=gen) < 0.5
            a = _uniform(torch.rand(remaining, generator=gen), 0.0, 2 * np.pi)
            dist = _uniform(torch.rand(remaining, generator=gen), 5.0, 12.0)
            cam_near = dumper + dist[:, None] * torch.stack([torch.cos(a), torch.sin(a)], -1)
            tgt_near = dumper + _uniform(torch.rand(remaining, 2, generator=gen), -1.0, 1.0)
            cam_far = _uniform(torch.rand(remaining, 2, generator=gen),
                               torch.tensor([-10.0, -10.0]), torch.tensor([8.0, 10.0]))
            tgt_far = _uniform(torch.rand(remaining, 2, generator=gen), -3.0, 3.0)
            cams.append(torch.where(near[:, None], cam_near, cam_far))
            tgts.append(torch.where(near[:, None], tgt_near, tgt_far))
    z = torch.as_tensor(np.resize(HEIGHTS, num_frames))[:, None]
    cam_pos = torch.cat([torch.cat(cams)[:num_frames], z], dim=-1)
    target = torch.cat([torch.cat(tgts)[:num_frames], z], dim=-1)
    return cam_pos, target
