"""The RGB epilogue: hit distance + instance map -> (B, H, W, 3) uint8.

``plain_rgb`` is the shading tier of ``render/shading.py`` (screen-space
normals, per-pixel table gather, local coordinates, procedural patterns,
contact AO, shade, gamma), the plain version of the port's RGB kernel.
With ``texels`` (the (T, B, B, 4) table of ``render/textures.dense_table``)
it applies the image textures after the procedural patterns
(``textures.apply_image_textures``), perturbs the normal with the normal map
(``shading.perturb_normal``) and adds the roughness specular to the shade.
``normal`` (B, H, W, 3) world normals replace the screen-space ones,
``shadow_t`` (B, H, W) gates the sun's direct and specular terms (lit where
``shadow_t >= 1e9``), and ``procedural=False`` shades the table's flat
albedo: no local coordinates, patterns, image textures or contact AO; the
hash noise stays. ``ao_rows_needed`` counts the contact-AO rows each ground
pixel lies within reach of, the work a bound charges.

Inputs, per frame:
* ``table`` (B, O + 2, 16) f32 rows [albedo 3 | world->local rotation
  (R row-major) 9 | instance position 3 | class 1]: instances, then the
  ground (class -1), then the sky (class -2).
* ``ao`` (B, A, 4) f32 rows [x, y, footprint radius, 0] of the contact-AO
  instances (``ao_rows``).
* ``params`` (B, 32) f32 per-frame scalars: ``camera.ray_params`` 0-15
  (ray basis 0-8, cx 9, cy 10, fx 11, fy 12, camera 13-15), sun_dir
  16-18, sun intensity 19, dome
  intensity 20, dome rgb 21-23, tex_phase 24, tex_strength 25, dirt 26.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import camera as cam_mod
from ..scene import world as world_mod
from . import shading as sh
from . import textures

Tensor = torch.Tensor

N_PAR = 32


def ao_rows(roster: world_mod.Roster):
    """Contact-AO rows: every non-fence instance, with its footprint radius
    capped at 2 m -> (rows (A,) int, foot_r (A,) f32)."""
    O = roster.num_instances
    f0, f1 = roster.fence_slice
    rows = np.concatenate([np.arange(f0), np.arange(f1, O)]).astype(np.int64)
    if rows.size == 0:
        rows = np.arange(O)
    foot_r = np.minimum(np.maximum(np.abs(roster.inst_aabb_min[rows, :2]),
                                   np.abs(roster.inst_aabb_max[rows, :2])).max(-1), 2.0)
    return rows, foot_r.astype(np.float32)


def instance_table(roster: world_mod.Roster, inst_rot: Tensor, inst_pos: Tensor) -> Tensor:
    """(B, O + 2, 16) per-instance table, ground and sky rows last."""
    B, O = inst_pos.shape[:2]
    dev = inst_pos.device
    albedo = torch.cat([roster.tensor("inst_albedo", dev),
                        torch.tensor([[0.45, 0.40, 0.35], [0.0, 0.0, 0.0]], device=dev)])
    rot = torch.cat([inst_rot.reshape(B, O, 9),
                     torch.eye(3, device=dev).reshape(1, 1, 9).expand(B, 2, 9)], dim=1)
    pos = torch.cat([inst_pos, torch.zeros(B, 2, 3, device=dev)], dim=1)
    cls = torch.cat([roster.tensor("inst_class_id", dev).float(),
                     torch.tensor([-1.0, -2.0], device=dev)])
    return torch.cat([albedo.expand(B, -1, -1), rot, pos, cls.expand(B, -1)[..., None]],
                     dim=2).contiguous()


def ao_table(roster: world_mod.Roster, inst_pos: Tensor) -> Tensor:
    """(B, A, 4) [x, y, footprint radius, 0] of the contact-AO rows."""
    rows, foot_r = ao_rows(roster)
    B = inst_pos.shape[0]
    dev = inst_pos.device
    xy = inst_pos[:, torch.as_tensor(rows, device=dev), :2]
    r = torch.as_tensor(foot_r, device=dev).expand(B, -1)[..., None]
    return torch.cat([xy, r, torch.zeros_like(r)], dim=2).contiguous()


def rgb_params(M: Tensor, cam_pos: Tensor, intr: cam_mod.Intrinsics,
               lighting: sh.Lighting) -> Tensor:
    """(B, 32) per-frame scalars in the layout of the module docstring."""
    B = M.shape[0]
    col = lambda v: v.reshape(B, 1)
    vals = torch.cat([cam_mod.ray_params(M, cam_pos, intr), lighting.sun_dir,
                      col(lighting.sun_intensity), col(lighting.dome_intensity),
                      lighting.dome_color, col(lighting.tex_phase),
                      col(lighting.tex_strength), col(lighting.dirt)], dim=1)
    return torch.cat([vals, vals.new_zeros(B, N_PAR - vals.shape[1])], dim=1).contiguous()


def hit_points(t: Tensor, params: Tensor):
    """(rd, pw): the unit rays and the hit points (the camera on a miss) of
    ``plain_rgb``, each three (B, H, W) planes."""
    B, H, W = t.shape
    dev = t.device
    p = lambda k: params[:, k].reshape(B, 1, 1)
    x = (torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] - p(9)) / p(11)
    y = (torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] - p(10)) / p(12)
    r = [p(3 * i) * x + p(3 * i + 1) * y + p(3 * i + 2) for i in range(3)]
    n = torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    rd = tuple(c / n for c in r)
    ts = torch.where(torch.isfinite(t), t, 0.0)
    return rd, tuple(p(13 + i) + ts * rd[i] for i in range(3))


def table_rows(inst: Tensor, table: Tensor) -> Tensor:
    """(B, H, W, 16): each pixel's table row (instances, then the ground on
    inst -1 and the sky on inst -2)."""
    n_inst = table.shape[1] - 2
    idx = torch.where(inst >= 0, inst, n_inst - 1 - inst).long()
    return table[torch.arange(inst.shape[0], device=inst.device)[:, None, None], idx]


def local_coords(pw, tab: Tensor):
    """(lx, ly, lz): the hit points ``pw`` in their instance's frame, from
    the table rows ``tab`` (R (pw - position), as the kernel rounds it)."""
    dw = tuple(pw[i] - tab[..., 12 + i] for i in range(3))
    return tuple(tab[..., 3 + i] * dw[0] + tab[..., 6 + i] * dw[1] + tab[..., 9 + i] * dw[2]
                 for i in range(3))


def plain_rgb(t: Tensor, inst: Tensor, table: Tensor, ao: Tensor, params: Tensor,
              texels: Tensor | None = None, normal: Tensor | None = None,
              shadow_t: Tensor | None = None, procedural: bool = True) -> Tensor:
    """Plain version of the kernel: (B, H, W, 3) uint8; with ``texels``
    the textured variant's, with ``normal``, ``shadow_t`` or
    ``procedural=False`` the tier variants' (module docstring)."""
    B = t.shape[0]
    dev = t.device
    p = lambda k: params[:, k].reshape(B, 1, 1)
    rd, pw = hit_points(t, params)
    if normal is None:
        normal = sh.screen_space_normals(pw, rd)
    else:
        normal = (normal[..., 0], normal[..., 1], normal[..., 2])

    tab = table_rows(inst, table)
    albedo = (tab[..., 0], tab[..., 1], tab[..., 2])
    rough = spec_w = ao_f = None
    if procedural:
        lx, ly, lz = local_coords(pw, tab)
        cls = tab[..., 15]
        albedo = sh.procedural_albedo(albedo, lx, ly, lz, cls, p(24), p(26))
        if texels is not None:
            albedo, (du, dv, rough, spec_w) = textures.apply_image_textures(
                albedo, lx, ly, lz, pw[0], pw[1], cls, texels, p(24))
            normal = sh.perturb_normal(normal, du, dv)

        prox = torch.ones_like(t)
        for a in range(ao.shape[1]):
            q = lambda k: ao[:, a, k].reshape(B, 1, 1)
            dxa, dya = pw[0] - q(0), pw[1] - q(1)
            d = torch.sqrt(dxa * dxa + dya * dya)
            prox = torch.minimum(prox, torch.clamp((d - q(2)) / 0.6, 0.0, 1.0))
        ao_f = torch.where(inst == -1, 0.45 + 0.55 * prox, 1.0)

    lighting = sh.Lighting(sun_dir=params[:, 16:19], sun_intensity=params[:, 19],
                           dome_intensity=params[:, 20], dome_color=params[:, 21:24],
                           tex_phase=params[:, 24], tex_strength=params[:, 25],
                           dirt=params[:, 26])
    planes = sh.shade(t, normal, pw, rd, albedo, lighting, ao=ao_f, rough=rough, spec_w=spec_w,
                      shadow_t=shadow_t)
    return sh.linear_to_srgb_u8(planes)


def ao_rows_needed(t: Tensor, inst: Tensor, ao: Tensor, params: Tensor) -> Tensor:
    """(B, H, W) int32: for each ground pixel the AO rows it lies within
    reach of (d < r + 0.6, where a row's term is below 1), 0 elsewhere."""
    pw = hit_points(t, params)[1]
    n = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    for a in range(ao.shape[1]):
        q = lambda k: ao[:, a, k][:, None, None]
        dxa, dya = pw[0] - q(0), pw[1] - q(1)
        n += (torch.sqrt(dxa * dxa + dya * dya) < q(2) + 0.6).int()
    return torch.where(inst == -1, n, 0)


def fused_rgb(t: Tensor, inst: Tensor, table: Tensor, ao: Tensor, params: Tensor,
              texels: Tensor | None = None, normal: Tensor | None = None,
              shadow_t: Tensor | None = None, procedural: bool = True) -> Tensor:
    """(B, H, W, 3) uint8: the kernel for CUDA tensors, the plain version for
    CPU tensors; any other device raises."""
    args = (t, inst, table, ao, params, texels, normal, shadow_t, procedural)
    return plain_rgb(*args)
