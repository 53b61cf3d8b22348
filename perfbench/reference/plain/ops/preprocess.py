"""Image preprocessing for the network (port of the JAX ``ops/preprocess.py``).

Frames are born on the device, so preprocessing is resize, the training
step's photometric augment, then normalize. The augment takes its random
draws as an argument (``AugmentDraws``): ``augment_draws`` makes them from
a frame's own streams (``utils/prng.py``), and the tests hand in the JAX
package's.

Resizing matches ``jax.image.resize(..., "bilinear")``: half-pixel centres,
and an antialiasing (widened triangle) kernel on an axis that shrinks, plain
bilinear weights on one that grows.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import prng

Tensor = torch.Tensor

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _resize_axis(x: Tensor, size, antialias: bool) -> Tensor:
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=antialias)


def resize_bilinear(img: Tensor, out_h: int, out_w: int) -> Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C), align_corners=False."""
    *lead, H, W, C = img.shape
    x = img.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    if (out_h < H) == (out_w < W) or out_h == H or out_w == W:
        x = _resize_axis(x, (out_h, out_w), out_h < H or out_w < W)
    else:  # one axis shrinks, the other grows: one pass per axis
        x = _resize_axis(x, (out_h, W), out_h < H)
        x = _resize_axis(x, (out_h, out_w), out_w < W)
    return x.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, C)


# The JAX augment's ranges (its defaults, which no caller changes).
BRIGHTNESS, CONTRAST, HUE_SHIFT, NOISE_STD = 0.2, 0.2, 0.05, 0.02


class AugmentDraws(NamedTuple):
    """A batch's augment draws: 1 + U(-BRIGHTNESS, BRIGHTNESS) (B,),
    1 + U(-CONTRAST, CONTRAST) (B,), per-channel gains 1 + U(-HUE_SHIFT,
    HUE_SHIFT) (B, 3) and a standard normal image (B, H, W, 3)."""

    brightness: Tensor
    contrast: Tensor
    gains: Tensor
    noise: Tensor


def augment_draws(seed: int, frame_ids: Sequence[int], height: int, width: int,
                  device="cpu") -> AugmentDraws:
    """The augment draws of training frames ``frame_ids``: the five scalars
    of a frame from its CPU stream, its noise image drawn on ``device`` by a
    generator there (32 x 512^2 x 3 normals a step would cost the host tens
    of ms)."""
    device = torch.device(device)
    fids = [int(f) for f in frame_ids]
    noise = torch.empty(len(fids), height, width, 3, device=device)
    u = torch.empty(len(fids), 5)
    for i, f in enumerate(fids):
        g_host, g_dev = prng.augment_generators(seed, f, device)
        u[i] = torch.rand(5, generator=g_host)
        torch.randn(height, width, 3, generator=g_dev, device=device, out=noise[i])
    return draws_from_uniforms(u, noise)


def draws_from_uniforms(u: Tensor, noise: Tensor) -> AugmentDraws:
    """AugmentDraws from uniforms u (B, 5) in [0, 1) (brightness, contrast,
    three gains) and a standard normal noise image (B, H, W, 3); the
    scalars go to the noise's device."""
    lo = torch.tensor([-BRIGHTNESS, -CONTRAST] + [-HUE_SHIFT] * 3)
    s = (1.0 + lo + u * (-2.0 * lo)).to(noise.device)
    return AugmentDraws(s[:, 0], s[:, 1], s[:, 2:], noise)


def photometric_augment(img: Tensor, draws: AugmentDraws) -> Tensor:
    """img float32 (B, H, W, 3) in [0, 1] -> the jittered image in [0, 1]:
    contrast about the per-channel mean, brightness, channel gains, noise."""
    b = draws.brightness[:, None, None, None]
    c = draws.contrast[:, None, None, None]
    mean = torch.mean(img, dim=(-3, -2), keepdim=True)
    img = (img - mean) * c + mean * b
    img = img * draws.gains[:, None, None, :]
    img = img + NOISE_STD * draws.noise
    return torch.clamp(img, 0.0, 1.0)


def normalize(img: Tensor) -> Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


def preprocess_frame(rgb_u8: Tensor, out_h: int, out_w: int, augment: bool = False,
                     draws: AugmentDraws | None = None) -> Tensor:
    """uint8 (..., H, W, 3) -> normalized float32 (..., out_h, out_w, 3);
    ``augment=True`` (frames (B, H, W, 3)) applies ``photometric_augment``
    with ``draws`` after the resize."""
    img = rgb_u8.to(torch.float32) / 255.0
    if img.shape[-3] != out_h or img.shape[-2] != out_w:
        img = resize_bilinear(img, out_h, out_w)
    if augment:
        if draws is None:
            raise ValueError("augment=True needs the augment draws (augment_draws)")
        img = photometric_augment(img, draws)
    return normalize(img)
