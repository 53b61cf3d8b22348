"""Lighting domain randomization (port of the JAX ``sample/lighting.py``):
sun direction over an elevation/azimuth range, multiplicative intensity
jitter, and the procedural-texture knobs, per frame."""

from __future__ import annotations

import torch

from ..config import LightingConfig
from ..render.shading import Lighting

Tensor = torch.Tensor

LIGHTING_DRAWS = 7  # elevation, azimuth, sun, dome, phase, strength, dirt


def lighting_draws(gen: torch.Generator, n: int) -> Tensor:
    """(n, LIGHTING_DRAWS) uniforms in [0, 1) for ``lighting_from_draws``."""
    return torch.rand(n, LIGHTING_DRAWS, generator=gen)


def lighting_from_draws(u: Tensor, cfg: LightingConfig = LightingConfig()) -> Lighting:
    """Uniforms (B, 7) -> a batched ``Lighting`` (fields lead with B)."""
    def uni(k, lo, hi):
        return lo + u[..., k] * (hi - lo)

    elev = torch.deg2rad(uni(0, *cfg.sun_elevation_range))
    azim = torch.deg2rad(uni(1, *cfg.sun_azimuth_range))
    # Direction the light travels (from the sun toward the ground): -z.
    sun_dir = torch.stack([torch.cos(elev) * torch.cos(azim),
                           torch.cos(elev) * torch.sin(azim),
                           -torch.sin(elev)], dim=-1)
    jit = cfg.intensity_jitter
    sun_i = 1.0 + uni(2, -jit, jit)
    dome_i = 1.0 + uni(3, -jit, jit)
    dome = torch.tensor(cfg.dome_color, dtype=torch.float32, device=u.device)
    return Lighting(
        sun_dir=sun_dir,
        sun_intensity=sun_i * (cfg.distant_intensity_cap / 1500.0),
        dome_intensity=dome_i * (cfg.dome_intensity / 500.0),
        dome_color=dome.expand(u.shape[:-1] + (3,)),
        tex_phase=u[..., 4],
        tex_strength=uni(5, 0.5, 1.5),
        dirt=uni(6, 0.0, 0.8),
    )


