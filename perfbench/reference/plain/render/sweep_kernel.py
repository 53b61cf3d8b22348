"""The pixel sweep: every pixel ray of a batch of frames against every
primitive, as one packed (t | instance code) f32 per pixel.

``plain_pixel_sweep`` is the packed caster's plain version on
``camera.pixel_rays``, the plain version of the port's pixel-sweep kernel
(``csrc/sweep.cu``). The static schedule built here once per roster holds
one row per primitive with its operation (transform category x kind), pose
row, payload code (instance + 2) and fence axis swap, plus its 4
parameters, and each row's bounding radius (``bounding_radii``).
``needed_pairs`` counts the (ray, row) pairs these inputs need, whatever
the tiling: the work a bound of the kernel charges.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import camera as cam_mod
from ..scene import assets, world as world_mod
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


def build_schedule(roster: world_mod.Roster, prim_mask: np.ndarray | None = None):
    """(sched_i (S, 4) int32 [op, prim row, code, swap], sched_f (S, 4) f32):
    a row per primitive, or per primitive where ``prim_mask`` (P,) holds."""
    cats = raycast._transform_categories(roster)
    if prim_mask is not None:
        cats = raycast._masked_categories(cats, prim_mask)
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


def bounding_radii(sched_i: np.ndarray, sched_f: np.ndarray) -> np.ndarray:
    """(S,) f32: the radius of each schedule row's bounding sphere about its
    primitive's position, ``raycast.kind_radii`` of its operation's kind;
    -1 for the plane, which the cull always keeps."""
    kind = {op: k for (_, k), op in OPS.items()}
    kinds = np.asarray([kind[int(op)] for op in sched_i[:, 0]], np.int64)
    return raycast.kind_radii(kinds, sched_f)


def needed_pairs(sched_i: Tensor, radii: Tensor, world, cam_pos: Tensor, M: Tensor,
                 intr: cam_mod.Intrinsics):
    """(row_pixels (B, S), pixel_rows (B, H*W)) int64: for each schedule row
    the pixels whose ray (a half-line from the camera) meets its bounding
    sphere, and for each pixel the rows its ray meets, the plane counted
    always. The work any cull must still do; computed frame by frame."""
    plane = sched_i[:, 0] == 0
    row_px, px_rows = [], []
    for b in range(cam_pos.shape[0]):
        d = cam_mod.pixel_rays(intr, M[b:b + 1]).reshape(-1, 3)  # (N, 3)
        v = world["prim_pos"][b, sched_i[:, 1].long()] - cam_pos[b]  # (S, 3)
        vv = torch.sum(v * v, -1)
        tc = d @ v.T  # (N, S)
        meet = (((tc > 0) & (vv - tc * tc <= radii * radii))
                | (vv <= radii * radii) | plane)
        row_px.append(meet.sum(0))
        px_rows.append(meet.sum(1))
    return torch.stack(row_px), torch.stack(px_rows)


def plain_pixel_sweep(caster: raycast.Raycaster, world, cam_pos: Tensor, M: Tensor,
                      intr: cam_mod.Intrinsics) -> Tensor:
    """Plain version: (B, H*W) packed sweep of ``pixel_rays`` by the
    caster's plain version (never a kernel, on any device)."""
    dirs = cam_mod.pixel_rays(intr, M)
    return caster.plain_packed(world, cam_pos, dirs.reshape(M.shape[0], -1, 3))


class PixelSweeper:
    """``sweeper(world, cam_pos (B, 3), M (B, 3, 3)) -> (B, H*W) packed``
    for a fixed roster and intrinsics; with ``prim_mask`` (P,) bool, over
    the primitives where it holds (the plain version then needs a
    ``caster`` built with the same mask)."""

    def __init__(self, roster: world_mod.Roster, intr: cam_mod.Intrinsics,
                 caster: raycast.Raycaster | None = None,
                 prim_mask: np.ndarray | None = None):
        self.intr = intr
        self.caster = caster or raycast.Raycaster(roster, prim_mask=prim_mask)
        self.sched_i, self.sched_f = build_schedule(roster, prim_mask)
        self.radii = bounding_radii(self.sched_i, self.sched_f)
        self._device_sched = {}


    def __call__(self, world, cam_pos: Tensor, M: Tensor) -> Tensor:
        return plain_pixel_sweep(self.caster, world, cam_pos, M, self.intr)
