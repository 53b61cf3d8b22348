"""CSPoseNet: images -> heatmaps -> decoded keypoints -> equipment 6DoF
(port of the JAX ``models/pose_net.py``).

Channel layout comes from ``scene/assets.keypoint_channel_table()``:
contiguous per-class blocks in class-id order.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops import decode as decode_ops
from ..ops import pnp as pnp_ops
from ..scene import assets
from . import backbone

Tensor = torch.Tensor


def class_channel_slices() -> Dict[str, tuple]:
    """{class_name: (start, stop)} channel ranges."""
    table, _ = assets.keypoint_channel_table()
    out: Dict[str, list] = {}
    for (name, k), ch in table.items():
        lo, hi = out.get(name, [ch, ch])
        out[name] = [min(lo, ch), max(hi, ch)]
    return {n: (lo, hi + 1) for n, (lo, hi) in out.items()}


def make_model(num_channels: int | None = None, lite: bool = False, output_stride: int = 4,
               device: str | torch.device = "cuda", seed: int = 0,
               dtype: torch.dtype = torch.bfloat16) -> backbone._Backbone:
    """The backbone with flax's default initialization drawn from ``seed``,
    on ``device`` (the card unless the caller asks for the CPU), in eval
    mode. On the card the weights take the channels-last layout that cuDNN's
    bf16 convolutions prefer."""
    num_channels = num_channels or assets.NUM_KEYPOINT_CHANNELS
    if lite:
        if output_stride != 4:
            raise ValueError("LiteBackbone is stride-4 only")
        model = backbone.LiteBackbone(num_channels, dtype=dtype)
    else:
        model = backbone.HeatmapBackbone(num_channels, output_stride=output_stride, dtype=dtype)
    model = backbone.init_weights(model, seed).to(device).eval()
    if model.head.weight.is_cuda:
        model = model.to(memory_format=torch.channels_last)
    return model


def forward(model: backbone._Backbone, images: Tensor) -> Tensor:
    """images (B, H, W, 3) -> raw heatmaps (B, C, H/s, W/s), contiguous and
    channel-major as ops.decode and ops.heatmap expect. The NHWC input is
    handed over as a channels-last NCHW view, with no copy; the output is
    made contiguous once here rather than by every decoder."""
    return model(images.permute(0, 3, 1, 2)).contiguous()


def output_to_heatmaps(raw: Tensor, loss: str = "mse") -> Tensor:
    """The focal loss trains logits, so decoding sees sigmoid(output); MSE
    trains heatmap values directly (identity)."""
    return torch.sigmoid(raw) if loss == "focal" else raw


def decode_keypoints(heatmaps: Tensor, stride: float = 4.0, use_dark: bool = True):
    """(B, C, h, w) -> uv in input-image pixels (B, C, 2) + scores (B, C)."""
    fn = decode_ops.dark_decode if use_dark else decode_ops.soft_argmax
    uv, score = fn(heatmaps)
    return uv * stride, score


def equipment_pose(class_name: str, uv_pixels: Tensor, scores: Tensor, fx: float, fy: float,
                   cx: float, cy: float, score_threshold: float = 0.3) -> pnp_ops.PnPResult:
    """6DoF camera-frame pose of one equipment class from its decoded
    keypoint channels (B, C_total, 2) / (B, C_total), by batched PnP."""
    lo, hi = class_channel_slices()[class_name]
    model_pts = torch.as_tensor(assets.all_templates()[class_name].keypoints,
                                dtype=torch.float32, device=uv_pixels.device)
    sc = scores[:, lo:hi]
    w = torch.where(sc >= score_threshold, sc, 0.0)
    x = pnp_ops.normalize_pixels(uv_pixels[:, lo:hi], fx, fy, cx, cy)
    return pnp_ops.solve_pnp(model_pts.expand(x.shape[0], -1, -1), x, w)
