"""The pixel sweep: every pixel ray of a batch of frames against every
primitive, as one packed (t | instance code) f32 per pixel.

Kernel: ``csrc/sweep.cu`` (replaces the Pallas TPU kernel of the JAX
``render/sweep_kernel.py``). Plain version: ``plain_pixel_sweep``, the
packed caster's plain version on ``camera.pixel_rays``. ``PixelSweeper``
dispatches on the device of its inputs: CUDA tensors launch the kernel,
CPU tensors take the plain version.

The kernel reads a static schedule built here once per roster: one row per
primitive with its operation (transform category x kind), pose row,
payload code (instance + 2) and fence axis swap, plus its 4 parameters,
and each row's bounding radius (``bounding_radii``). It is bound by
arithmetic, and a brute-force walk spends most of it on primitives a ray
cannot hit, so each 32 x 8 pixel tile first culls the rows whose bounding
sphere lies outside its ray cone (``tile_cull_plain`` mirrors that test)
and walks only the rest. ``needed_pairs`` counts the (ray, row) pairs
these inputs need, whatever the tiling: the work a bound charges. The
kernel rebuilds unit rays in-kernel, so it agrees with the plain version
to the tolerance of grazing silhouettes, not bit for bit.
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
TILE = (32, 8)  # csrc/sweep.cu kTileW, kTileH: a block's pixel tile
# The cull widens a tile's cone angle to (1 + CULL_REL) alpha + CULL_ABS rad
# and each bounding radius to (1 + CULL_REL) R (csrc/sweep.cu kCullRel,
# kCullAbs).
CULL_REL = 1e-3
CULL_ABS = 1e-6


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


def _rays(basis: Tensor, intr: cam_mod.Intrinsics, cols: Tensor, rows: Tensor) -> Tensor:
    """Unit rays through pixel positions (cols, rows) (...,), as csrc/sweep.cu
    builds them: (B, ..., 3)."""
    x = (cols - intr.cx) / intr.fx
    y = (rows - intr.cy) / intr.fy
    bs = basis.reshape(basis.shape[0], *([1] * cols.dim()), 3, 3)
    d = bs[..., 0] * x[..., None] + bs[..., 1] * y[..., None] + bs[..., 2]
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _angle(a: Tensor, v: Tensor) -> Tensor:
    """Angle between unit ``a`` and ``v`` (broadcast over ..., 3)."""
    return torch.atan2(torch.linalg.norm(torch.linalg.cross(a, v, dim=-1), dim=-1),
                       torch.sum(a * v, -1))


def tile_cull_plain(sched_i: Tensor, radii: Tensor, world, cam_pos: Tensor, M: Tensor,
                    intr: cam_mod.Intrinsics) -> Tensor:
    """The kernel's tile cull, on tensors: (B, tiles_y, tiles_x, S) bool,
    True where the tile keeps the schedule row."""
    H, W = intr.height, intr.width
    dev = cam_pos.device
    c0 = torch.arange(0, W, TILE[0], device=dev, dtype=torch.float32)
    r0 = torch.arange(0, H, TILE[1], device=dev, dtype=torch.float32)
    c1 = torch.clamp_max(c0 + TILE[0] - 1, W - 1)
    r1 = torch.clamp_max(r0 + TILE[1] - 1, H - 1)
    grid = lambda c, r: torch.meshgrid(r, c, indexing="ij")[::-1]  # (ty, tx) cols, rows
    basis = cam_mod.pinhole_basis(M)
    axis = _rays(basis, intr, *grid(0.5 * (c0 + c1), 0.5 * (r0 + r1)))  # (B, ty, tx, 3)
    alpha = torch.stack([_angle(axis, _rays(basis, intr, *grid(c, r)))
                         for c in (c0, c1) for r in (r0, r1)]).amax(0)
    alpha = alpha * (1.0 + CULL_REL) + CULL_ABS
    ca = torch.where(alpha < 1.5707963, torch.cos(alpha), -2.0)[..., None]
    sa = torch.sin(alpha)[..., None]
    rad = radii * (1.0 + CULL_REL)
    v = world["prim_pos"][:, sched_i[:, 1].long()] - cam_pos[:, None]  # (B, S, 3)
    d2 = torch.sum(v * v, -1)
    av = torch.sum(axis[:, :, :, None] * v[:, None, None], -1)  # (B, ty, tx, S)
    # angle <= alpha' + asin(R' / d), as cos(angle) >= cos(alpha' + beta')
    keep = av >= (ca * torch.sqrt(torch.clamp_min(d2 - rad * rad, 0.0))[:, None, None]
                  - sa * rad)
    return keep | (ca < -1.0) | (d2 <= rad * rad)[:, None, None] | (sched_i[:, 0] == 0)


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


def sweep_cuda(sched_i: Tensor, sched_f: Tensor, world, cam_pos: Tensor, M: Tensor,
               intr: cam_mod.Intrinsics, radii: Tensor) -> Tensor:
    """Launch csrc/sweep.cu: (B, H*W) packed f32. ``radii`` (S,) are the
    rows' ``bounding_radii``; the kernel refuses a schedule whose rows do
    not fit a block's shared memory."""
    B = cam_pos.shape[0]
    P = world["prim_pos"].shape[1]
    S = sched_i.shape[0]
    cam = cam_mod.ray_params(M, cam_pos, intr).contiguous()
    poses = torch.cat([world["prim_pos"], world["prim_rot"].reshape(B, P, 9)], dim=2).contiguous()
    kernels.check_cuda("sweep cam", cam, torch.float32, (B, N_CAM))
    kernels.check_cuda("sweep poses", poses, torch.float32, (B, P, 12))
    kernels.check_cuda("sweep sched_i", sched_i, torch.int32, (S, 4))
    kernels.check_cuda("sweep sched_f", sched_f, torch.float32, (S, 4))
    kernels.check_cuda("sweep radii", radii, torch.float32, (S,))
    out = torch.empty(B, intr.height * intr.width, dtype=torch.float32, device=cam.device)
    kernels.launch("cspe_sweep", cam, poses, sched_i, sched_f, radii, S, P, B, intr.height,
                   intr.width, out)
    sweep_cuda.launches += 1
    return out


sweep_cuda.launches = 0


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

    def schedule(self, device) -> tuple[Tensor, Tensor, Tensor]:
        """The schedule as (sched_i, sched_f, radii) tensors on ``device``
        (cached)."""
        key = str(device)
        if key not in self._device_sched:
            self._device_sched[key] = tuple(torch.as_tensor(a, device=device) for a in
                                            (self.sched_i, self.sched_f, self.radii))
        return self._device_sched[key]

    def __call__(self, world, cam_pos: Tensor, M: Tensor) -> Tensor:
        if not cam_pos.is_cuda:
            return plain_pixel_sweep(self.caster, world, cam_pos, M, self.intr)
        si, sf, radii = self.schedule(cam_pos.device)
        return sweep_cuda(si, sf, world, cam_pos, M, self.intr, radii)
