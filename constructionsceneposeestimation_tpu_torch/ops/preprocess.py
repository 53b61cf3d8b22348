"""Image preprocessing for the network (port of the JAX ``ops/preprocess.py``).

Frames are born on the device, so preprocessing is resize + normalize.
``photometric_augment`` draws random numbers and is training-only; it comes
with the training step (``ROADMAP.md``).

Resizing matches ``jax.image.resize(..., "bilinear")``: half-pixel centres,
and an antialiasing (widened triangle) kernel on an axis that shrinks, plain
bilinear weights on one that grows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def normalize(img: Tensor) -> Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


def preprocess_frame(rgb_u8: Tensor, out_h: int, out_w: int,
                     augment: bool = False) -> Tensor:
    """uint8 (..., H, W, 3) -> normalized float32 (..., out_h, out_w, 3)."""
    if augment:
        raise NotImplementedError(
            "photometric_augment comes with the training step (ROADMAP.md)")
    img = rgb_u8.to(torch.float32) / 255.0
    if img.shape[-3] != out_h or img.shape[-2] != out_w:
        img = resize_bilinear(img, out_h, out_w)
    return normalize(img)
