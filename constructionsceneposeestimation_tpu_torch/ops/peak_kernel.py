"""Multi-peak heatmap decoding: relu -> 3x3 blur -> 3x3 NMS -> K
max-and-suppress rounds -> DARK refinement, per (H, W) map.

Kernel: ``csrc/peaks.cu`` (replaces the Pallas TPU kernel ``_peak_kernel``
of the JAX ``ops/peak_kernel.py``). Plain version: ``extract_peaks_plain``,
with the same selection rule: each round takes the largest remaining value,
the lowest row and then the lowest column on ties, and suppresses it to 0,
so a map with fewer than K positive peaks repeats its first pixel with
score 0. ``ops/decode.extract_peaks`` dispatches on the device.

The kernel reads each map once and is bound by that read. It streams the
map through registers instead of staging it in shared memory: one warp
walks a band of rows of a 128-column strip with a rolling window of
relu'd and blurred rows, keeps NMS survivors in a small buffer that it
reduces to its top K, and the map's warps merge their sorted lists. So
small blocks of many maps share an SM and one map's loads overlap
another's work, and the kernel takes any leading dims and any H, W >= 3
(no block padding, no lane alignment, no size limit). The header of
``csrc/peaks.cu`` has the layout.
"""

from __future__ import annotations

import math

import torch

from ..utils import kernels
from . import decode

Tensor = torch.Tensor

MAX_PEAKS = 512  # the largest K the kernel takes


def extract_peaks_plain(heatmaps: Tensor, max_peaks: int = 8, blur: bool = True,
                        eps: float = 1e-8):
    """Plain version: (..., H, W) -> (uv (..., K, 2), scores (..., K)) f32."""
    *lead, H, W = heatmaps.shape
    x = torch.clamp_min(heatmaps.reshape(-1, H, W).float(), 0.0)
    hb = decode._gaussian_blur_3x3(x) if blur else x
    peak = torch.where(hb >= decode._max_pool_3x3(hb), x, 0.0)
    flat = peak.reshape(-1, H * W).clone()
    idx, val = [], []
    for _ in range(max_peaks):
        i = torch.argmax(flat, -1, keepdim=True)  # first of equal values
        val.append(torch.gather(flat, -1, i))
        idx.append(i)
        flat.scatter_(-1, i, 0.0)
    idx = torch.cat(idx, -1)
    py, px = idx // W, idx % W
    nb = decode._extract_neighborhoods(hb, py, px)  # (N, K, 3, 3)
    off_x, off_y = decode._dark_refine(nb, py, px, H, W, eps)
    uv = torch.stack([px + off_x, py + off_y], -1)
    return (uv.reshape(*lead, max_peaks, 2),
            torch.cat(val, -1).reshape(*lead, max_peaks))


def nms_survivors(heatmaps: Tensor, blur: bool = True) -> Tensor:
    """(..., H, W) -> (...,) int64: the positive NMS survivors of each map,
    the candidates the kernel's per-warp buffers take in."""
    *lead, H, W = heatmaps.shape
    x = torch.clamp_min(heatmaps.reshape(-1, H, W).float(), 0.0)
    hb = decode._gaussian_blur_3x3(x) if blur else x
    keep = (hb >= decode._max_pool_3x3(hb)) & (x > 0)
    return keep.reshape(*lead, H * W).sum(-1)


def peaks_cuda(heatmaps: Tensor, max_peaks: int = 8, blur: bool = True, eps: float = 1e-8):
    """Launch csrc/peaks.cu on (..., H, W) f32 contiguous maps."""
    *lead, H, W = heatmaps.shape
    kernels.check_cuda("peaks heatmaps", heatmaps, torch.float32)
    if H < 3 or W < 3:
        raise ValueError(f"peaks: maps must be at least 3 x 3, got {H} x {W}")
    if not 1 <= max_peaks <= MAX_PEAKS:
        raise ValueError(f"peaks: max_peaks must be in [1, {MAX_PEAKS}], got {max_peaks}")
    n = math.prod(lead)
    uv = torch.empty(*lead, max_peaks, 2, dtype=torch.float32, device=heatmaps.device)
    scores = torch.empty(*lead, max_peaks, dtype=torch.float32, device=heatmaps.device)
    if n:
        kernels.launch("cspe_peaks", heatmaps, n, H, W, max_peaks, int(blur), float(eps),
                       uv, scores)
        peaks_cuda.launches += 1
    return uv, scores


peaks_cuda.launches = 0
