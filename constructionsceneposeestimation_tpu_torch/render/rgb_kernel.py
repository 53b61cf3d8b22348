"""The RGB epilogue: hit distance + instance map -> (B, H, W, 3) uint8.

Kernel: ``csrc/rgb.cu`` (replaces the Pallas TPU kernel of the JAX
``render/rgb_kernel.py``; its header says what bounds it on an H100).
Plain version: ``plain_rgb``, the shading tier of ``render/shading.py``
(screen-space normals, per-pixel table gather, local coordinates,
procedural patterns, contact AO, shade, gamma). ``fused_rgb`` dispatches on
the device of its inputs.

The textured variant (``texels``, the (T, B, B, 4) table of
``render/textures.dense_table``) is the same kernel compiled with its
``TEX`` flag: after the procedural patterns it applies the image textures
(``textures.apply_image_textures``), perturbs the normal with the normal
map (``shading.perturb_normal``) and adds the roughness specular to the
shade, in JAX's textured order. ``rgb_cuda.launches`` counts untextured
launches, ``rgb_cuda.textured_launches`` textured ones.

The tiers of ``annotate.render_frame`` that the JAX package shades in
``jnp`` (``annotate.py:276-280``) are variants of the same kernel, chosen
by a tier mask at compile time (``TIERS``; csrc/rgb.cu ``TIER``):
``normal`` (B, H, W, 3) world normals replace the screen-space ones (the
analytic-normal caster's), ``shadow_t`` (B, H, W) gates the sun's direct
and specular terms (lit where ``shadow_t >= 1e9``), and ``procedural=False``
shades the table's flat albedo: no local coordinates, patterns, image
textures (``texels`` is dropped, as JAX's texture block sits inside its
procedural branch) or contact AO; the hash noise stays.
``rgb_cuda.tier_launches[name]`` counts the launches of each such variant
(``variant_name``), which ``launches`` and ``textured_launches`` do not
include.

``texture_plan_plain`` mirrors the textured kernel's mask ladder: each
pixel's texture slot, texel bins and weights, which the kernel computes
before its texel loads.

The kernel culls the contact-AO rows per 32 x 1 row of a tile (a warp):
it keeps the rows whose widened reach meets the xy box of the row's ground
hit points, and every culled row's term is exactly 1 there.
``ao_cull_plain`` mirrors that test op for op; ``ao_rows_needed`` counts
the rows each ground pixel lies within reach of, the work a bound charges.

Inputs shared by both versions, per frame:
* ``table`` (B, O + 2, 16) f32 rows [albedo 3 | world->local rotation
  (R row-major) 9 | instance position 3 | class 1]: instances, then the
  ground (class -1), then the sky (class -2). It stays f32.
* ``ao`` (B, A, 4) f32 rows [x, y, footprint radius, 0] of the contact-AO
  instances (``ao_rows``).
* ``params`` (B, 32) f32 per-frame scalars: ``camera.ray_params`` 0-15
  (ray basis 0-8, cx 9, cy 10, fx 11, fy 12, camera 13-15), sun_dir
  16-18, sun intensity 19, dome
  intensity 20, dome rgb 21-23, tex_phase 24, tex_strength 25, dirt 26.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam_mod
from ..scene import world as world_mod
from ..utils import kernels
from . import shading as sh
from . import textures

Tensor = torch.Tensor

N_PAR = 32
TILE = (32, 8)  # csrc/rgb.cu kTileW, kTileH: a block's pixel tile
# The cull widens a row's reach r + 0.6 m to (r + 0.6) AO_SCALE + AO_ABS
# (csrc/rgb.cu kAoScale, kAoAbs).
AO_SCALE = 1.0001
AO_ABS = 1e-4
TEX_BINS = 128  # csrc/rgb.cu kTexBins: the texel table's bins a side
# csrc/rgb.cu's tier mask bits.
TIER_NORMAL, TIER_SHADOW, TIER_FLAT = 1, 2, 4
TIERS = {TIER_FLAT: "flat", TIER_NORMAL: "normal", TIER_SHADOW: "shadow"}


def tier_mask(normal=None, shadow_t=None, procedural: bool = True) -> int:
    """csrc/rgb.cu's tier mask of a launch."""
    return ((TIER_NORMAL if normal is not None else 0)
            | (TIER_SHADOW if shadow_t is not None else 0) | (0 if procedural else TIER_FLAT))


def variant_name(textured: bool, tier: int) -> str:
    """"default", "textured", or the variant's parts joined by "+" (e.g.
    "textured+normal+shadow", "flat+shadow")."""
    parts = (["textured"] if textured else []) + [n for b, n in TIERS.items() if tier & b]
    return "+".join(parts) or "default"


# Every tier variant the wrapper launches: the flat ones are untextured.
VARIANTS = tuple(variant_name(tex, tier) for tex in (False, True) for tier in range(1, 8)
                 if not (tex and tier & TIER_FLAT))


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


class TexturePlan(NamedTuple):
    """The textured kernel's mask ladder per pixel (``texture_plan_plain``),
    each (B, H, W)."""

    slot: Tensor  # int64 texture slot of the mix sample, -1 where none
    ub: Tensor  # int64 texel bins of both samples (floor modulo TEX_BINS)
    vb: Tensor
    w: Tensor  # f32 mix weight (0 where the albedo stays)
    nr_slot: Tensor  # int64 *_nr slot of the map sample, -1 where none
    w_nr: Tensor  # f32 map weight (0 where no map applies)
    takes_r_xy: Tensor  # bool: the ladder takes r_xy (tree pixels)
    takes_theta: Tensor  # bool: the ladder takes theta (trunks and garments)


def texture_plan_plain(t: Tensor, inst: Tensor, table: Tensor, params: Tensor) -> TexturePlan:
    """What the textured kernel plans for each pixel before the texel loads,
    on tensors: the slot, bins and mix weight of the first sample and the
    slot and weight of the normal map's. A pixel that misses plans no
    sample; a hit pixel of mix weight 0 samples only on the vest (whose
    weave needs it); one of map weight 0 reads no map. Its local
    coordinates and (u, v) take the kernel's operations in its order
    (``local_coords``, ``textures.mask_ladder``); the kernel computes
    r_xy only on trees and theta only on trunks and garments, where the
    ladder reads them (``takes_r_xy``, ``takes_theta``)."""
    B = t.shape[0]
    pw = hit_points(t, params)[1]
    tab = table_rows(inst, table)
    lx, ly, lz = local_coords(pw, tab)
    lad = textures.mask_ladder(lx, ly, lz, pw[0], pw[1], tab[..., 15],
                               params[:, 24].reshape(B, 1, 1))
    hit = torch.isfinite(t)
    sampled = hit & ((lad.w != 0.0) | lad.vest)
    mapped = hit & (lad.w_nr != 0.0)
    tree = hit & (tab[..., 15] == 1.0)
    trunk = tree & (lad.tex == float(textures.TEX["bark"]))
    return TexturePlan(torch.where(sampled, lad.tex.long(), -1),
                       textures.texel_bin(lad.u, TEX_BINS), textures.texel_bin(lad.v, TEX_BINS),
                       torch.where(hit, lad.w, 0.0), torch.where(mapped, lad.nr_tex.long(), -1),
                       torch.where(hit, lad.w_nr, 0.0), tree,
                       trunk | (hit & (lad.vest | lad.legs | lad.shirt)))


def ao_cull_plain(t: Tensor, inst: Tensor, ao: Tensor, params: Tensor) -> Tensor:
    """The kernel's contact-AO cull, on tensors: (B, H, cells_x, A) bool,
    True where the cell of 32 x 1 pixels keeps AO row a. A cell keeps a
    row whose disc of radius (r + 0.6) AO_SCALE + AO_ABS meets the xy
    bounding box of the cell's ground hit points, in the f32 operations of
    csrc/rgb.cu's ``ao_reaches``; a cell with no ground pixel keeps none."""
    B, H, W = t.shape
    pw = hit_points(t, params)[1]
    ground = inst == -1
    cw = TILE[0]
    inf = float("inf")

    def cells(v, fill):  # (B, H, W) -> (B, H, cells_x, 32)
        v = torch.nn.functional.pad(torch.where(ground, v, fill), (0, -W % cw), value=fill)
        return v.reshape(B, H, -1, cw)

    x0, x1 = cells(pw[0], inf).amin(-1), cells(pw[0], -inf).amax(-1)
    y0, y1 = cells(pw[1], inf).amin(-1), cells(pw[1], -inf).amax(-1)
    q = lambda k: ao[:, None, None, :, k]
    box = lambda v: v[..., None]
    dx = torch.clamp_min(torch.maximum(box(x0) - q(0), q(0) - box(x1)), 0.0)
    dy = torch.clamp_min(torch.maximum(box(y0) - q(1), q(1) - box(y1)), 0.0)
    reach = (q(2) + 0.6) * AO_SCALE + AO_ABS
    return (dx * dx + dy * dy <= reach * reach) & box(x0 <= x1)


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


def rgb_cuda(t: Tensor, inst: Tensor, table: Tensor, ao: Tensor, params: Tensor,
             texels: Tensor | None = None, normal: Tensor | None = None,
             shadow_t: Tensor | None = None, procedural: bool = True) -> Tensor:
    """Launch csrc/rgb.cu, textured where ``texels`` (T, 128, 128, 4) is
    given (and ``procedural``), in the tier variant of ``normal``,
    ``shadow_t`` and ``procedural``: (B, H, W, 3) uint8. The kernel refuses
    a table and AO rows that do not fit a block's shared memory."""
    B, H, W = t.shape
    R, A = table.shape[1], ao.shape[1]
    kernels.check_cuda("rgb t", t, torch.float32)
    kernels.check_cuda("rgb inst", inst, torch.int32, (B, H, W))
    kernels.check_cuda("rgb table", table, torch.float32, (B, R, 16))
    kernels.check_cuda("rgb ao", ao, torch.float32, (B, A, 4))
    kernels.check_cuda("rgb params", params, torch.float32, (B, N_PAR))
    if not procedural:
        texels = None
    if texels is not None:
        kernels.check_cuda("rgb texels", texels, torch.float32,
                           (len(textures.TEX), TEX_BINS, TEX_BINS, 4))
    if normal is not None:
        kernels.check_cuda("rgb normal", normal, torch.float32, (B, H, W, 3))
    if shadow_t is not None:
        kernels.check_cuda("rgb shadow_t", shadow_t, torch.float32, (B, H, W))
    tier = tier_mask(normal, shadow_t, procedural)
    out = torch.empty(B, H, W, 3, dtype=torch.uint8, device=t.device)
    kernels.launch("cspe_rgb_tier", t, inst, table, R, ao, A, params, texels, normal, shadow_t,
                   tier, B, H, W, out)
    name = variant_name(texels is not None, tier)
    if name == "default":
        rgb_cuda.launches += 1
    elif name == "textured":
        rgb_cuda.textured_launches += 1
    else:
        rgb_cuda.tier_launches[name] += 1
    return out


rgb_cuda.launches = 0
rgb_cuda.textured_launches = 0
rgb_cuda.tier_launches = dict.fromkeys(VARIANTS, 0)


def fused_rgb(t: Tensor, inst: Tensor, table: Tensor, ao: Tensor, params: Tensor,
              texels: Tensor | None = None, normal: Tensor | None = None,
              shadow_t: Tensor | None = None, procedural: bool = True) -> Tensor:
    """(B, H, W, 3) uint8: the kernel for CUDA tensors, the plain version for
    CPU tensors; any other device raises."""
    args = (t, inst, table, ao, params, texels, normal, shadow_t, procedural)
    if t.is_cuda:
        return rgb_cuda(*args)
    if t.device.type == "cpu":
        return plain_rgb(*args)
    raise ValueError(f"fused_rgb: no RGB path for a tensor on {t.device}")
