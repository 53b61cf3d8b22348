"""The image-texture tier: the reference's real texture images (bark, leaf,
garment fabrics, ground) sampled on top of the procedural patterns (port
of the JAX ``render/textures.py``).

The images ship as separable low-rank factors (``data/texture_factors.npz``
at the root of the repository, baked by ``tools/build_texture_atlas.py``):

    img[t, u, v, c] ~= sum_k U[t, u, k, c] * V[t, v, k, c]

with T = 13 textures, B = 128 bins a side and rank K = 12. ``sample`` is
the JAX function on tensors: it gathers the rows ``tex * B + bin`` of the
packed (T * B, 3K) tables and takes the sum over k for each channel, then
the clip. The JAX package builds those gathers as one-hot contractions for
the TPU's matrix unit; a gather is the same function.

The RGB kernel (csrc/rgb.cu) and its plain version read ``dense_table``
instead: the (T, B, B, 4) table of every texel, each entry the same
clipped sum of K products, computed once (a fourth lane pads a texel to
16 bytes; 3.4 MB, which stays in the H100's 50 MB L2). A pixel's sample
is then one 16-byte load. ``sample_texels`` is that load on tensors.

``apply_image_textures`` is the class-conditioned mapping (the JAX
function with ``with_nr=True``): the mask ladder (``mask_ladder``) that
picks a texture and its (u, v) per pixel, the garment tints, the mix over the procedural
albedo, the vest's fabric weave, and the ``*_nr`` sample of the packed
[nx, ny, roughness] composites. It works on (B, H, W) planes with a
per-frame ``tex_phase``. Labels never read any of this.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
Planes3 = Tuple[Tensor, Tensor, Tensor]

FACTORS_NPZ = Path(__file__).resolve().parents[5] / "data" / "texture_factors.npz"

# Slot order of the factor file; index = texture id. The *_nr slots pack
# [nx, ny, roughness] composites (normal z is not stored).
TEX = {"bark": 0, "branches": 1, "leaf": 2, "bark_rough": 3,
       "twill": 4, "denim": 5, "ground": 6, "dirt": 7, "cot_ox": 8,
       "denim_nr": 9, "cot_ox_nr": 10, "twill_nr": 11, "leaf_nr": 12}

# Garment tints (linear RGB): the fabric diffuses are grayscale, so the
# trousers and the shirt take a work-wear colour times the fabric.
LEGS_TINT = (0.83, 1.15, 2.90)
SHIRT_TINT = (0.95, 1.08, 1.33)


class TextureFactors(NamedTuple):
    """Packed low-rank factor tables, rows grouped per texture."""

    U: Tensor  # (T * B, 3K) f32, columns channel-major [c * K + k]
    V: Tensor  # (T * B, 3K) f32
    bins: int
    rank: int
    n_tex: int


def load_factors(path: str | Path = FACTORS_NPZ) -> TextureFactors:
    """The factor file's f16 U, V (T, B, K, 3) as f32 packed tables on the
    host."""
    with np.load(path) as z:
        U, V = z["U"].astype(np.float32), z["V"].astype(np.float32)
        bins, rank, names = int(z["bins"]), int(z["rank"]), [str(n) for n in z["names"]]
    if names != sorted(TEX, key=TEX.get):
        raise ValueError(f"{path}: texture slots {names} are not in the order of TEX")
    T = U.shape[0]
    pack = lambda a: torch.as_tensor(
        np.ascontiguousarray(a.transpose(0, 1, 3, 2).reshape(T * bins, 3 * rank)))
    return TextureFactors(pack(U), pack(V), bins, rank, T)


def texel_bin(x: Tensor, bins: int) -> Tensor:
    """floor(x * bins) modulo bins, the floor modulo (jnp's ``%``): every
    texture tiles, and negative coordinates are common."""
    return torch.remainder(torch.floor(x * bins).to(torch.int64), bins)


def sample(factors: TextureFactors, u: Tensor, v: Tensor, tex_id: Tensor) -> Planes3:
    """Linear RGB planes of textures ``tex_id`` at (u, v): any real
    coordinates (wrapped), planes of any shape. One channel at a time, so a
    gather holds (N, K) values, not (N, 3K)."""
    B, K = factors.bins, factors.rank
    rows_u = tex_id.long() * B + texel_bin(u, B)
    rows_v = tex_id.long() * B + texel_bin(v, B)
    out = []
    for c in range(3):
        F = factors.U[:, c * K:(c + 1) * K][rows_u]
        G = factors.V[:, c * K:(c + 1) * K][rows_v]
        out.append(torch.clamp(torch.sum(F * G, dim=-1), 0.0, 1.0))
    return tuple(out)


def dense_table(factors: TextureFactors) -> Tensor:
    """(T, B, B, 4) f32: entry [t, u, v, c] = clip(sum_k U[t, u, k, c] V[t,
    v, k, c], 0, 1) for c < 3, and 0 in the fourth lane."""
    T, B, K = factors.n_tex, factors.bins, factors.rank
    U = factors.U.reshape(T, B, 3, K)
    V = factors.V.reshape(T, B, 3, K)
    rgb = torch.clamp(torch.einsum("tuck,tvck->tuvc", U, V), 0.0, 1.0)
    return torch.nn.functional.pad(rgb, (0, 1)).contiguous()


def sample_texels(texels: Tensor, u: Tensor, v: Tensor, tex_id: Tensor) -> Planes3:
    """``sample`` through the dense (T, B, B, 4) table: one texel a pixel."""
    B = texels.shape[1]
    idx = (tex_id.long() * B + texel_bin(u, B)) * B + texel_bin(v, B)
    s = texels.reshape(-1, 4)[idx.reshape(-1)].reshape(idx.shape + (4,))
    return s[..., 0], s[..., 1], s[..., 2]


class Ladder(NamedTuple):
    """The mask ladder's choice per pixel (``mask_ladder``)."""

    u: Tensor  # texel coordinates of both samples
    v: Tensor
    tex: Tensor  # float slot of the mix sample (``ground`` where none)
    w: Tensor  # mix weight (0 where the albedo stays)
    vest: Tensor  # bool: the twill weave multiplies the albedo
    legs: Tensor  # bool: denim, tinted LEGS_TINT
    shirt: Tensor  # bool: cot_ox, tinted SHIRT_TINT
    nr_tex: Tensor  # float *_nr slot of the map sample (0 where none)
    w_nr: Tensor  # map weight (0 where no map applies)


def mask_ladder(lx: Tensor, ly: Tensor, lz: Tensor, pwx: Tensor, pwy: Tensor,
                class_id: Tensor, tex_phase: Tensor) -> Ladder:
    """The class-conditioned mapping of ``apply_image_textures``: per pixel
    the texture slot and its (u, v), the mix weight, the garment masks, and
    the ``*_nr`` slot and map weight.

      ground:       ``ground`` planar 6 m tiles, 45% over the base
      tree trunk:   ``bark`` cylindrical, 85%
      tree crown:   ``leaf`` planar 1.5 m tiles, 50%; ``leaf_nr`` 0.8
      dumper low:   ``dirt`` grime, 50%
      worker legs:  ``denim`` wrap, tinted, replacing the base; ``denim_nr``
      worker vest:  ``twill`` weave multiplying the hi-vis base; ``twill_nr``
      worker chest: ``cot_ox`` shirt, tinted, replacing the base; ``cot_ox_nr``
    """
    r_xy = torch.sqrt(lx * lx + ly * ly)
    theta = torch.atan2(ly, lx) * (0.5 / math.pi) + 0.5  # [0, 1)
    phase = tex_phase
    u = pwx * (1.0 / 6.0) + phase
    v = pwy * (1.0 / 6.0)
    tex = torch.full_like(class_id, float(TEX["ground"]))
    w = torch.where(class_id == -1.0, 0.45, 0.0)

    def place(mask, uu, vv, tid, ww):
        nonlocal u, v, tex, w
        u = torch.where(mask, uu, u)
        v = torch.where(mask, vv, v)
        tex = torch.where(mask, float(tid), tex)
        w = torch.where(mask, ww, w)

    is_tree = class_id == 1.0
    trunk = is_tree & (r_xy < 0.45) & (lz < 3.2)
    crown = is_tree & ~trunk
    place(trunk, theta + phase, lz * (1.0 / 2.5), TEX["bark"], 0.85)
    place(crown, lx * (1.0 / 1.5) + phase, lz * (1.0 / 1.5), TEX["leaf"], 0.5)
    place((class_id == 4.0) & (lz < 0.55), lx * 0.35 + phase, ly * 0.35, TEX["dirt"], 0.5)
    is_human = class_id == 5.0
    vest = is_human & (lz > 1.02) & (lz < 1.48)
    legs = is_human & (lz <= 1.02)
    shirt = is_human & (lz >= 1.48) & (lz < 1.58)
    place(vest, theta * 4.0 + phase, lz * 2.0, TEX["twill"], 0.0)
    place(legs, theta * 2.0 + phase, lz * 1.2, TEX["denim"], 1.0)
    place(shirt, theta * 3.0 + phase, lz * 1.6, TEX["cot_ox"], 1.0)

    nr_tex = torch.zeros_like(class_id)
    w_nr = torch.zeros_like(lx)
    for mask, tid, ww in ((crown, TEX["leaf_nr"], 0.8), (legs, TEX["denim_nr"], 1.0),
                          (vest, TEX["twill_nr"], 1.0), (shirt, TEX["cot_ox_nr"], 1.0)):
        nr_tex = torch.where(mask, float(tid), nr_tex)
        w_nr = torch.where(mask, ww, w_nr)
    return Ladder(u, v, tex, w, vest, legs, shirt, nr_tex, w_nr)


def apply_image_textures(albedo: Planes3, lx: Tensor, ly: Tensor, lz: Tensor, pwx: Tensor,
                         pwy: Tensor, class_id: Tensor, texels: Tensor, tex_phase: Tensor):
    """Class-conditioned image texturing over the procedural albedo ->
    ``(albedo, (du, dv, rough, w_nr))``.

    (lx, ly, lz): the hit in the owning instance's frame; (pwx, pwy): in
    the world frame (ground UVs); ``class_id`` float (-1 ground, -2 sky);
    ``tex_phase`` broadcasts against the planes. ``mask_ladder`` picks each
    pixel's texture, (u, v) and weight; the garments are tinted, the mix
    replaces a share of the albedo, the vest's weave multiplies it.

    The second sample reads the matching ``*_nr`` slot at the same (u, v)
    on the leaf crown and the three garments: tangent-space normal offsets
    du, dv in [-1, 1] and roughness, weighted by ``w_nr`` (0 elsewhere)."""
    lad = mask_ladder(lx, ly, lz, pwx, pwy, class_id, tex_phase)
    tex_rgb = sample_texels(texels, lad.u, lad.v, lad.tex)
    tint = [torch.where(lad.legs, a, torch.where(lad.shirt, b, 1.0))
            for a, b in zip(LEGS_TINT, SHIRT_TINT)]
    tex_rgb = tuple(torch.clamp(t_ * s, 0.0, 1.0) for t_, s in zip(tint, tex_rgb))
    out = tuple(a * (1.0 - lad.w) + t_ * lad.w for a, t_ in zip(albedo, tex_rgb))
    # The vest's weave multiplies the hi-vis base instead of replacing it.
    weave = 0.6 + 0.8 * tex_rgb[0]
    out = tuple(torch.where(lad.vest, a * weave, o) for a, o in zip(albedo, out))

    nx_s, ny_s, rough = sample_texels(texels, lad.u, lad.v, lad.nr_tex)
    du = (2.0 * nx_s - 1.0) * lad.w_nr
    dv = (2.0 * ny_s - 1.0) * lad.w_nr
    return out, (du, dv, rough, lad.w_nr)
