"""The pixel sweep: every pixel ray of a batch of frames against every
primitive, as one packed (t | instance code) f32 per pixel.

Kernel: ``csrc/sweep.cu`` (replaces the Pallas TPU kernel of the JAX
``render/sweep_kernel.py``; its header says what bounds it on an H100).
Plain version: ``plain_pixel_sweep``, the packed caster on
``camera.pixel_rays``. ``PixelSweeper`` dispatches on the device of its
inputs: CUDA tensors launch the kernel, CPU tensors take the plain version.

The kernel reads a static schedule built here once per roster: one row per
primitive with its operation (transform category x kind), pose row,
payload code (instance + 2) and fence axis swap, plus its 4 parameters.
The kernel rebuilds unit rays in-kernel, so it agrees with the plain
version to the tolerance of grazing silhouettes, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import camera as cam_mod
from ..scene import assets, world as world_mod
from ..utils import kernels
from . import raycast

Tensor = torch.Tensor

# Schedule operations; the numbering is csrc/sweep.cu's ``Op``.
OPS = {
    ("inv", assets.PLANE): 0,
    ("inv", assets.SPHERE): 1,
    ("inv", assets.CYLINDER): 2,
    ("inv", assets.CONE): 3,
    ("aa_id", assets.BOX): 4,
    ("aa_swap", assets.BOX): 4,
    ("yaw", assets.BOX): 5,
    ("axis", assets.CAPSULE): 6,
    ("gen", assets.BOX): 7,
    ("gen", assets.CYLINDER): 8,
}
N_CAM = 16  # camera.ray_params: basis 9 | cx cy fx fy | camera xyz


def build_schedule(roster: world_mod.Roster):
    """(sched_i (S, 4) int32 [op, prim row, code, swap], sched_f (S, 4) f32)."""
    cats = raycast._transform_categories(roster)
    rows_i, rows_f = [], []
    for cat, lst in cats.items():
        for kind, idx in lst:
            if (cat, kind) not in OPS:
                raise ValueError(f"no sweep-kernel operation for {assets.KIND_NAMES[kind]} "
                                 f"in category {cat!r}")
            for p in idx:
                rows_i.append([OPS[(cat, kind)], int(p), int(roster.prim_inst[p]) + 2,
                               int(cat == "aa_swap")])
                rows_f.append(roster.prim_params[p])
    return np.asarray(rows_i, np.int32), np.asarray(rows_f, np.float32)


def plain_pixel_sweep(caster: raycast.Raycaster, world, cam_pos: Tensor, M: Tensor,
                      intr: cam_mod.Intrinsics) -> Tensor:
    """Plain version: (B, H*W) packed sweep of ``pixel_rays``."""
    dirs = cam_mod.pixel_rays(intr, M)
    return caster.packed(world, cam_pos, dirs.reshape(M.shape[0], -1, 3))


def sweep_cuda(sched_i: Tensor, sched_f: Tensor, world, cam_pos: Tensor, M: Tensor,
               intr: cam_mod.Intrinsics) -> Tensor:
    """Launch csrc/sweep.cu: (B, H*W) packed f32."""
    B = cam_pos.shape[0]
    P = world["prim_pos"].shape[1]
    S = sched_i.shape[0]
    cam = cam_mod.ray_params(M, cam_pos, intr).contiguous()
    poses = torch.cat([world["prim_pos"], world["prim_rot"].reshape(B, P, 9)], dim=2).contiguous()
    kernels.check_cuda("sweep cam", cam, torch.float32, (B, N_CAM))
    kernels.check_cuda("sweep poses", poses, torch.float32, (B, P, 12))
    kernels.check_cuda("sweep sched_i", sched_i, torch.int32, (S, 4))
    kernels.check_cuda("sweep sched_f", sched_f, torch.float32, (S, 4))
    if S * 32 + (N_CAM + P * 12) * 4 > kernels.SMEM_LIMIT:
        raise ValueError(f"sweep: {S} schedule rows / {P} poses exceed shared memory")
    out = torch.empty(B, intr.height * intr.width, dtype=torch.float32, device=cam.device)
    kernels.launch("cspe_sweep", cam, poses, sched_i, sched_f, S, P, B, intr.height,
                   intr.width, out)
    sweep_cuda.launches += 1
    return out


sweep_cuda.launches = 0


class PixelSweeper:
    """``sweeper(world, cam_pos (B, 3), M (B, 3, 3)) -> (B, H*W) packed``
    for a fixed roster and intrinsics."""

    def __init__(self, roster: world_mod.Roster, intr: cam_mod.Intrinsics,
                 caster: raycast.Raycaster | None = None):
        self.intr = intr
        self.caster = caster or raycast.Raycaster(roster)
        self.sched_i, self.sched_f = build_schedule(roster)
        self._device_sched = {}

    def schedule(self, device) -> tuple[Tensor, Tensor]:
        """The schedule as (sched_i, sched_f) tensors on ``device`` (cached)."""
        key = str(device)
        if key not in self._device_sched:
            self._device_sched[key] = (torch.as_tensor(self.sched_i, device=device),
                                       torch.as_tensor(self.sched_f, device=device))
        return self._device_sched[key]

    def __call__(self, world, cam_pos: Tensor, M: Tensor) -> Tensor:
        if not cam_pos.is_cuda:
            return plain_pixel_sweep(self.caster, world, cam_pos, M, self.intr)
        return sweep_cuda(*self.schedule(cam_pos.device), world, cam_pos, M, self.intr)
