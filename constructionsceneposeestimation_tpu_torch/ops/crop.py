"""Detect-then-crop ROI ops for the two-stage (top-down) pose path (port of
the JAX ``ops/crop.py``).

A 2D box (the renderer's ``bbox2d`` label in training and evaluation, a
detector's box in deployment) selects an ROI, the ROI is resampled to a
fixed size, and a second-stage net finds keypoints in crop coordinates,
where the object fills the frame.

``crop_resize`` is ``jax.image.scale_and_translate(..., "linear")``: a
separable resample with one fractional scale and shift per ROI and axis,
antialiased (a widened triangle) on an axis that shrinks. Neither
``F.interpolate`` (no shift) nor ``grid_sample`` (no antialias) computes it,
so the per-ROI weight matrices are built as JAX builds them
(``jax._src.image.scale.compute_weight_mat``) and contracted with two
batched matmuls. It is jnp in JAX, not a Pallas kernel.

``jitter_roi`` takes its uniform draws as an argument, as the augment does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_WEIGHT_SUM_EPS = 1000.0 * float(np.finfo(np.float32).eps)


def square_roi(bbox: Tensor, margin: float = 0.25,
               min_half: float = 8.0) -> Tuple[Tensor, Tensor, Tensor]:
    """bbox (..., 4) [u0, v0, u1, v1] -> (cu, cv, half) square ROI: the
    tight box grown by ``margin``, its half side at least ``min_half``."""
    u0, v0, u1, v1 = bbox.unbind(-1)
    cu = (u0 + u1) * 0.5
    cv = (v0 + v1) * 0.5
    half = torch.clamp_min(torch.maximum(u1 - u0, v1 - v0) * 0.5 * (1.0 + margin), min_half)
    return cu, cv, half


def rect_roi(bbox: Tensor, margin: float = 0.25, min_half: float = 8.0,
             max_aspect: float = 3.0) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """bbox (..., 4) -> (cu, cv, half_u, half_v): per-axis halves, so a thin
    part fills the crop, with the anisotropy bounded by ``max_aspect``."""
    u0, v0, u1, v1 = bbox.unbind(-1)
    cu = (u0 + u1) * 0.5
    cv = (v0 + v1) * 0.5
    hu = torch.clamp_min((u1 - u0) * 0.5 * (1.0 + margin), min_half)
    hv = torch.clamp_min((v1 - v0) * 0.5 * (1.0 + margin), min_half)
    hu = torch.maximum(hu, hv / max_aspect)
    hv = torch.maximum(hv, hu / max_aspect)
    return cu, cv, hu, hv


def jitter_roi(d: Tensor, cu: Tensor, cv: Tensor, half: Tensor, shift_frac: float = 0.1,
               scale_frac: float = 0.15, half_v: Tensor | None = None):
    """Detector-noise augmentation from ``d`` (..., 3), uniform in [-1, 1):
    shift by d[0], d[1] times ``shift_frac`` of the half side, scale by
    1 + d[2] * ``scale_frac``. With ``half_v`` (``rect_roi``) the shifts are
    per axis and one scale keeps the aspect; a 4-tuple is returned."""
    d0, d1, d2 = d.unbind(-1)
    if half_v is None:
        return (cu + d0 * shift_frac * half, cv + d1 * shift_frac * half,
                half * (1.0 + d2 * scale_frac))
    s = 1.0 + d2 * scale_frac
    return cu + d0 * shift_frac * half, cv + d1 * shift_frac * half_v, half * s, half_v * s


def weight_matrix(in_size: int, out_size: int, scale: Tensor, translation: Tensor) -> Tensor:
    """The linear (triangle) resample weights of one axis, (..., out, in),
    for per-ROI ``scale`` and ``translation`` (...): output pixel o samples
    the input at (o + 0.5 - t) / s - 0.5; the triangle is widened by 1 / s
    where s < 1 (antialias); each row is divided by its sum when that sum
    exceeds 1000 f32 eps, else zeroed, and zeroed where the sample lies
    outside [-0.5, in - 0.5]. The operations run in JAX's order."""
    dev = scale.device
    inv = 1.0 / scale[..., None]
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv
              - translation[..., None] * inv - 0.5)  # (..., out)
    kernel_scale = torch.clamp_min(inv, 1.0)[..., None]
    x = torch.abs(sample[..., None] - torch.arange(in_size, dtype=torch.float32, device=dev))
    w = torch.clamp_min(1.0 - x / kernel_scale, 0.0)  # (..., out, in)
    total = torch.sum(w, -1, keepdim=True)
    w = torch.where(torch.abs(total) > _WEIGHT_SUM_EPS,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], w, 0.0)


def crop_resize(img: Tensor, cu: Tensor, cv: Tensor, half: Tensor, out: int,
                half_v: Tensor | None = None) -> Tensor:
    """img (B, H, W, C) float, ROIs (B,) or (B, R) -> crops (B, out, out, C)
    or (B, R, out, out, C): the bilinear resample of [cu - half, cu + half]
    x [cv - half_v, cv + half_v] (square when ``half_v`` is None;
    fractional coordinates), zero where a crop pixel samples outside the
    frame. The rows of every ROI are contracted in one matmul per frame,
    then the columns in one per ROI."""
    B, H, W, C = img.shape
    per_frame = cu.ndim == 1
    hv = half if half_v is None else half_v
    cu, cv, half, hv = (x.reshape(B, -1) for x in (cu, cv, half, hv))
    R = cu.shape[1]
    scale_u = out / (2.0 * half)
    scale_v = out / (2.0 * hv)
    # Input coordinate x maps to scale * x + translation; cu - half -> 0.
    wu = weight_matrix(W, out, scale_u, -scale_u * (cu - half))  # (B, R, out, W)
    wv = weight_matrix(H, out, scale_v, -scale_v * (cv - hv))  # (B, R, out, H)
    rows = torch.matmul(wv.reshape(B, R * out, H), img.reshape(B, H, W * C))
    rows = rows.reshape(B, R, out, W, C).transpose(2, 3).reshape(B, R, W, out * C)
    crops = torch.matmul(wu, rows).reshape(B, R, out, out, C).transpose(2, 3)
    return crops[:, 0] if per_frame else crops


def uv_to_crop(uv: Tensor, cu: Tensor, cv: Tensor, half: Tensor, out: int,
               half_v: Tensor | None = None) -> Tensor:
    """Image-pixel keypoints (..., 2) -> crop-pixel coordinates."""
    hv = half if half_v is None else half_v
    return torch.stack([(uv[..., 0] - (cu - half)) * (out / (2.0 * half)),
                        (uv[..., 1] - (cv - hv)) * (out / (2.0 * hv))], -1)


def crop_to_uv(uv_crop: Tensor, cu: Tensor, cv: Tensor, half: Tensor, out: int,
               half_v: Tensor | None = None) -> Tensor:
    """Inverse of ``uv_to_crop``."""
    hv = half if half_v is None else half_v
    return torch.stack([uv_crop[..., 0] * ((2.0 * half) / out) + (cu - half),
                        uv_crop[..., 1] * ((2.0 * hv) / out) + (cv - hv)], -1)
