"""Gaussian keypoint-heatmap targets.

Channel c holds the max over the visible keypoints assigned to c of
exp(-d^2 / 2 sigma^2), with keypoints at uv / stride.

Kernel: ``csrc/heatmap.cu`` (replaces the Pallas TPU kernel of the JAX
``ops/heatmap.py``; its header says what bounds it on an H100). It writes
every pixel of every map, so it takes any sigma and any map width, with no
row window and no size fallback; it skips a keypoint only on rows where
its Gaussian is exactly 0 in f32 (``row_keep_plain`` mirrors that test).
Plain version: ``render_heatmaps``, which materializes (B, N, h, w).
``heatmaps`` dispatches on the device of its inputs.
"""

from __future__ import annotations

import torch


Tensor = torch.Tensor


def render_heatmaps(uv: Tensor, channel: Tensor, visible: Tensor, num_channels: int,
                    height: int, width: int, sigma: float, stride: float = 1.0) -> Tensor:
    """Plain version: uv (B, N, 2) at full resolution, channel (B, N) in
    [0, C), visible (B, N) -> (B, C, h, w) f32."""
    B, N = channel.shape
    dev = uv.device
    u = uv[..., 0] / stride
    v = uv[..., 1] / stride
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    d2 = ((xs[None, None, None, :] - u[..., None, None]) ** 2
          + (ys[None, None, :, None] - v[..., None, None]) ** 2)
    g = torch.exp(-d2 / (2.0 * sigma * sigma)) * visible[..., None, None].float()
    out = torch.zeros(B, num_channels, height, width, device=dev)
    index = channel.long()[..., None, None].expand(B, N, height, width)
    return out.scatter_reduce(1, index, g, "amax", include_self=True)


def heatmaps(uv: Tensor, channel: Tensor, visible: Tensor, num_channels: int, height: int,
             width: int, sigma: float, stride: float = 1.0) -> Tensor:
    """(B, C, h, w): the kernel for CUDA tensors, else the plain version."""
    return render_heatmaps(uv, channel, visible, num_channels, height, width, sigma, stride)


def frame_heatmaps(kpt_uv: Tensor, kpt_visible: Tensor, kpt_channel: Tensor,
                   num_channels: int, height: int, width: int, sigma: float,
                   stride: float) -> Tensor:
    """Per-object keypoints (B, O, K, 2), visibility (B, O, K) and the
    roster's channel table (O, K, -1 padded) -> (B, C, h, w)."""
    B = kpt_uv.shape[0]
    uv = kpt_uv.reshape(B, -1, 2).contiguous()
    ch = kpt_channel.reshape(1, -1).expand(B, -1)
    vis = (kpt_visible.reshape(B, -1) & (ch >= 0)).contiguous()
    ch = torch.clamp_min(ch, 0).to(torch.int32).contiguous()
    return heatmaps(uv, ch, vis, num_channels, height, width, sigma, stride)
