"""RGB synthesis: Lambert shading under a dome + one sun, procedural
textures, screen-space normals and the gamma curve (port of the JAX
``render/shading.py``). The formulas are the reference's; the CUDA RGB
kernel (csrc/rgb.cu) carries the same ones as device functions.

All functions take (B, H, W) component planes (or any shape that
broadcasts with them); per-frame lighting scalars are (B,) and are
broadcast by ``_per_frame``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor
Planes3 = Tuple[Tensor, Tensor, Tensor]


class Lighting(NamedTuple):
    """Per-frame lighting; every field leads with the batch dim B."""

    sun_dir: Tensor  # (B, 3) unit, the direction the light travels
    sun_intensity: Tensor  # (B,)
    dome_intensity: Tensor  # (B,)
    dome_color: Tensor  # (B, 3)
    tex_phase: Tensor  # (B,) stripe phase in [0, 1)
    tex_strength: Tensor  # (B,) hash-noise multiplier
    dirt: Tensor  # (B,) lower-body grime strength


def _per_frame(x: Tensor, like: Tensor) -> Tensor:
    """(B,) per-frame scalar -> broadcastable against (B, ...) ``like``."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _hash_noise(x: Tensor, y: Tensor, z: Tensor, scale: float = 7.0) -> Tensor:
    """Value noise in [0, 1) from hit-position planes: fract(|sin(p . k)| *
    43758.5453). The sin argument reaches ~1500, so the last ulps of each
    backend's sin decorrelate the noise: compare it statistically."""
    q = torch.sin(x * (12.9898 * scale) + y * (78.233 * scale) + z * (37.719 * scale))
    return torch.fmod(torch.abs(q * 43758.5453), 1.0)


_HIVIS = (0.85, 0.95, 0.05)
_WHITE = (0.92, 0.92, 0.92)
_SIGNAL_RED = (0.75, 0.10, 0.08)
_TRUNK_BROWN = (0.30, 0.20, 0.10)
_CAB_GRAY = (0.35, 0.38, 0.40)


def _override(rgb: Planes3, mask: Tensor, color) -> Planes3:
    return tuple(torch.where(mask, c, ch) for ch, c in zip(rgb, color))


def procedural_albedo(albedo: Planes3, x: Tensor, y: Tensor, z: Tensor,
                      class_id: Tensor, tex_phase: Tensor, dirt: Tensor) -> Planes3:
    """Class-conditioned procedural texturing in the owning instance's local
    frame: cone reflective bands, tree trunk, fence wire grid, dumper cab and
    grime, worker hi-vis vest and stripes, crane boom/telescopic hazard
    stripes. ``class_id`` is float (cone 0, tree 1, fence 2, dumper 4,
    human 5, crane parts 6-9, ground -1); ``tex_phase``/``dirt`` broadcast
    against the planes."""
    r_xy = torch.sqrt(x * x + y * y)
    out = albedo
    band = ((z > 0.28) & (z < 0.40)) | ((z > 0.50) & (z < 0.58))
    out = _override(out, (class_id == 0.0) & band, _WHITE)
    trunk = (class_id == 1.0) & (r_xy < 0.45) & (z < 3.2)
    out = _override(out, trunk, _TRUNK_BROWN)
    grid = (torch.sin(x * 18.0) * torch.sin(z * 18.0)) > 0.0
    fence_dark = (class_id == 2.0) & grid
    out = tuple(torch.where(fence_dark, ch * 0.75, ch) for ch in out)
    cab = (class_id == 4.0) & (x > 1.2) & (z > 0.6)
    out = _override(out, cab, _CAB_GRAY)
    grime = (class_id == 4.0) & (z < 0.55)
    dirt_mul = 1.0 - 0.5 * dirt
    out = tuple(torch.where(grime, ch * dirt_mul, ch) for ch in out)
    vest = (class_id == 5.0) & (z > 1.02) & (z < 1.48)
    out = _override(out, vest, _HIVIS)
    stripe_h = (class_id == 5.0) & (((z > 1.10) & (z < 1.16)) | ((z > 1.30) & (z < 1.36)))
    out = _override(out, stripe_h, _WHITE)
    # Python-style modulo (sign of the divisor), as jnp's ``%``.
    stripes = torch.remainder(torch.floor(x * 2.0 + tex_phase), 2.0) < 1.0
    boom_tel = (class_id == 8.0) | (class_id == 9.0)
    out = _override(out, boom_tel & stripes, _WHITE)
    out = _override(out, boom_tel & ~stripes, _SIGNAL_RED)
    return out


def screen_space_normals(pos: Planes3, ray_d: Planes3) -> Planes3:
    """World normals from finite differences of the (B, H, W) hit-position
    planes: n = d/drow x d/dcol, normalized, flipped toward the camera. The
    last row and column get a zero difference (``jnp.diff`` with the edge
    appended)."""
    def d_along(p, axis):
        d = torch.zeros_like(p)
        if axis == 2:
            d[..., :, :-1] = p[..., :, 1:] - p[..., :, :-1]
        else:
            d[..., :-1, :] = p[..., 1:, :] - p[..., :-1, :]
        return d

    dxx, dxy, dxz = (d_along(p, 2) for p in pos)
    dyx, dyy, dyz = (d_along(p, 1) for p in pos)
    nx = dyy * dxz - dyz * dxy
    ny = dyz * dxx - dyx * dxz
    nz = dyx * dxy - dyy * dxx
    inv = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-18))
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    flip = nx * ray_d[0] + ny * ray_d[1] + nz * ray_d[2] > 0
    sgn = torch.where(flip, -1.0, 1.0)
    return nx * sgn, ny * sgn, nz * sgn


def perturb_normal(normal: Planes3, du: Tensor, dv: Tensor, strength: float = 0.6) -> Planes3:
    """Tangent-space normal perturbation from normal-map offsets ``du``,
    ``dv`` (already weighted by the map's weight). The proxies carry no UV
    charts, so the frame is the chart-free one: t1 = normalize(n x up)
    (+x where the normal is vertical), t2 = n x t1. The result is
    renormalized, so where du = dv = 0 the normal moves by at most an ulp."""
    nx, ny, nz = normal
    mag = torch.sqrt(nx * nx + ny * ny)
    deg = mag < 1e-4
    inv = 1.0 / torch.where(deg, 1.0, mag)
    t1x = torch.where(deg, 1.0, ny * inv)
    t1y = torch.where(deg, 0.0, -nx * inv)
    t1z = torch.zeros_like(nx)
    t2x = ny * t1z - nz * t1y
    t2y = nz * t1x - nx * t1z
    t2z = nx * t1y - ny * t1x
    px = nx + strength * (du * t1x + dv * t2x)
    py = ny + strength * (du * t1y + dv * t2y)
    pz = nz + strength * (du * t1z + dv * t2z)
    rn = 1.0 / torch.sqrt(torch.clamp_min(px * px + py * py + pz * pz, 1e-12))
    return px * rn, py * rn, pz * rn


def shade(t: Tensor, normal: Planes3, hit_pos: Planes3, ray_d: Planes3,
          albedo: Planes3, lighting: Lighting, ao: Tensor | None = None,
          texture_strength: float = 0.15, rough: Tensor | None = None,
          spec_w: Tensor | None = None, shadow_t: Tensor | None = None) -> Planes3:
    """Shade (B, H, W) planes -> linear RGB planes in [0, 1]: hash-noise
    texture, Lambert sun, hemispheric dome ambient (times ``ao``), and the
    dome-coloured sky gradient where ``t`` is not finite. With ``rough`` and
    ``spec_w`` (the image-texture tier), a Blinn-Phong term of the sun is
    added to hit pixels: exponent 2 / max(r^2, 0.02), gloss (1 - r)^2,
    weighted by ``spec_w``, so a pixel of weight 0 adds an exact 0. With
    ``shadow_t`` (the hit distance toward the sun), a pixel is lit where
    ``shadow_t >= 1e9`` and the sun's direct and specular terms vanish
    elsewhere."""
    nx, ny, nz = normal
    is_hit = torch.isfinite(t)
    pf = lambda v: _per_frame(v, t)
    tex = 1.0 + texture_strength * pf(lighting.tex_strength) \
        * (_hash_noise(*hit_pos) - 0.5) * 2.0
    sd = lighting.sun_dir
    ndotl = torch.clamp_min(-(nx * pf(sd[:, 0]) + ny * pf(sd[:, 1]) + nz * pf(sd[:, 2])), 0.0)
    lit = None if shadow_t is None else (shadow_t >= 1e9).to(ndotl.dtype)
    direct = pf(lighting.sun_intensity) * ndotl
    if lit is not None:
        direct = direct * lit
    dome_i = pf(lighting.dome_intensity)
    ambient = dome_i * (0.25 + 0.35 * (0.5 * (1.0 + nz)))
    if ao is not None:
        ambient = ambient * ao
    sky_base = (0.85 + 0.15 * torch.clamp(ray_d[2], 0.0, 1.0)) * torch.clamp_min(dome_i, 0.3)
    spec = None
    if rough is not None and spec_w is not None:
        hx = -ray_d[0] - pf(sd[:, 0])
        hy = -ray_d[1] - pf(sd[:, 1])
        hz = -ray_d[2] - pf(sd[:, 2])
        hn = 1.0 / torch.sqrt(torch.clamp_min(hx * hx + hy * hy + hz * hz, 1e-12))
        ndoth = torch.clamp_min((nx * hx + ny * hy + nz * hz) * hn, 0.0)
        shin = 2.0 / torch.clamp_min(rough * rough, 0.02)
        gloss = torch.square(1.0 - rough)
        spec = spec_w * gloss * pf(lighting.sun_intensity)
        if lit is not None:
            spec = spec * lit
        spec = spec * torch.pow(ndoth, shin)
    out = []
    for ch, alb in enumerate(albedo):
        dc = pf(lighting.dome_color[:, ch])
        color = (alb * tex) * (direct + ambient * dc)
        if spec is not None:
            color = color + spec
        color = torch.where(is_hit, color, dc * sky_base)
        out.append(torch.clamp(color, 0.0, 1.0))
    return tuple(out)


def _gamma22(c: Tensor) -> Tensor:
    """x^(1/2.2) on [0, 1] by the reference's sqrt-chain fit (within 8e-2
    of one u8 level of the exact curve)."""
    s1 = torch.sqrt(c)
    s2 = torch.sqrt(s1)
    s3 = torch.sqrt(s2)
    a = s1 * (1.0 / torch.sqrt(torch.clamp_min(s3, 1e-30)))
    return a * (0.7844735 + 0.29726508 * s3 - 0.08179099 * s2)


def linear_to_srgb_u8(rgb: Planes3) -> Tensor:
    """Linear planes (B, H, W) in [0, 1] -> (B, H, W, 3) uint8 after gamma."""
    chans = [torch.round(_gamma22(torch.clamp(c, 0.0, 1.0)) * 255.0).to(torch.uint8)
             for c in rgb]
    return torch.stack(chans, dim=-1)
