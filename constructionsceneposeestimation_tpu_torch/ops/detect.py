"""CenterNet-style 2D detection: targets, loss and decode (port of the JAX
``ops/detect.py``), batched over frames.

Head layout (one backbone output, channel-major):

    [0, C)      per-class centre heatmaps (focal-trained logits)
    [C, C+2)    box size (w, h) in heatmap cells, regressed at the centre
    [C+2, C+4)  centre offset (the sub-stride residual)

The four crane parts are detected each as its own class and the whole
machine as one "crane" union box, a pseudo-instance the train and eval
wrappers append (``train/detect_loop.crane_extended_boxes``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..train import losses
from . import decode as decode_ops

Tensor = torch.Tensor

DET_CLASSES: Tuple[str, ...] = (
    "trafficcone", "tree", "fence", "dumper", "human", "crane",
    "cranebase", "cranecolumn", "craneboom", "cranetelescopic",
)
CRANE_PART_CLASSES: Tuple[str, ...] = DET_CLASSES[6:]

# Centre focal-loss weight per class: small or thin classes (cones, the
# worker, the telescopic section) count more.
CLASS_LOSS_WEIGHTS: Tuple[float, ...] = (2.0, 1.0, 1.0, 1.0, 4.0, 1.0, 1.0, 1.0, 1.0, 2.0)


def det_class_of_instances(roster) -> np.ndarray:
    """(O,) detection class per roster instance; crane parts map to their
    part classes (the union "crane" class has no roster instance)."""
    return np.asarray([DET_CLASSES.index(n) for n in roster.inst_class_names], np.int32)


def build_targets(bbox2d: Tensor, visible: Tensor, inst_cls: Tensor, hm_h: int, hm_w: int,
                  stride: float, min_sigma: float = 0.8):
    """Per-frame CenterNet targets, for frames (B, ...): boxes (B, O, 4)
    (-1 when unseen), visibility (B, O), detection class (O,) ->
    (centre (B, C, h, w), size (B, O, 2), offset (B, O, 2), pos_uv
    (B, O, 2) int64, pos_mask (B, O)). Each class map is the max of its
    instances' Gaussians (sigma grows with the box)."""
    C = len(DET_CLASSES)
    B, O = visible.shape
    dev = bbox2d.device
    b = bbox2d.float()
    cu = (b[..., 0] + b[..., 2]) * 0.5 / stride
    cv = (b[..., 1] + b[..., 3]) * 0.5 / stride
    w = (b[..., 2] - b[..., 0]) / stride
    h = (b[..., 3] - b[..., 1]) / stride
    pos_mask = visible & (w > 0) & (h > 0)
    ui = torch.clamp(torch.floor(cu), 0, hm_w - 1)
    vi = torch.clamp(torch.floor(cv), 0, hm_h - 1)
    sigma = torch.clamp_min(torch.maximum(w, h) / 6.0, min_sigma)
    xs = torch.arange(hm_w, dtype=torch.float32, device=dev)
    ys = torch.arange(hm_h, dtype=torch.float32, device=dev)
    d2 = ((xs - cu[..., None, None]) ** 2 + (ys[:, None] - cv[..., None, None]) ** 2)
    g = torch.exp(-d2 / (2.0 * sigma * sigma)[..., None, None])
    g = g * pos_mask[..., None, None].float()  # (B, O, h, w)
    index = inst_cls.to(dev).long()[None, :, None, None].expand(B, O, hm_h, hm_w)
    center = torch.zeros(B, C, hm_h, hm_w, device=dev).scatter_reduce(1, index, g, "amax")
    size = torch.stack([w, h], -1)
    offset = torch.stack([cu - ui, cv - vi], -1)
    pos_uv = torch.stack([ui, vi], -1).long()
    return center, size, offset, pos_uv, pos_mask


def _at_centres(maps: Tensor, pos_uv: Tensor) -> Tensor:
    """maps (B, 2, h, w) read at each instance's centre cell (B, O, 2) ->
    (B, O, 2)."""
    B, _, _, w = maps.shape
    idx = (pos_uv[..., 1] * w + pos_uv[..., 0])[:, None, :].expand(B, 2, -1)
    return torch.gather(maps.reshape(B, 2, -1), 2, idx).transpose(1, 2)


def detection_loss(pred: Tensor, center: Tensor, size: Tensor, offset: Tensor, pos_uv: Tensor,
                   pos_mask: Tensor, size_weight: float = 0.1, off_weight: float = 1.0,
                   class_weights: Tensor | None = None):
    """pred (B, C+4, h, w) against the targets of ``build_targets`` ->
    (loss (B,), {"hm", "size_l1", "off_l1"} (B,) each): per frame, the
    centre focal loss over its own positives (``class_weights`` (C,) on the
    class axis) plus the L1 of size and offset at the instances' centre
    cells, over its visible instances."""
    C = center.shape[1]
    hm_loss = losses.focal_per_sample(pred[:, :C], center, channel_weights=class_weights)
    m = pos_mask[..., None].float()
    n = torch.clamp_min(torch.sum(m, (1, 2)), 1.0)
    size_l1 = torch.sum(torch.abs(_at_centres(pred[:, C:C + 2], pos_uv) - size) * m, (1, 2)) / n
    off_l1 = torch.sum(torch.abs(_at_centres(pred[:, C + 2:C + 4], pos_uv) - offset) * m,
                       (1, 2)) / n
    return hm_loss + size_weight * size_l1 + off_weight * off_l1, {
        "hm": hm_loss, "size_l1": size_l1, "off_l1": off_l1}


def _local_max(hm: Tensor, k: int = 3) -> Tensor:
    """NMS by k x k max-pool equality (the pool's padding is -inf)."""
    mx = F.max_pool2d(hm, k, stride=1, padding=k // 2)
    return torch.where(hm >= mx, hm, 0.0)


def decode_detections(pred: Tensor, stride: float, max_det: int = 8, nms_k: int | None = None):
    """pred (B, C+4, h, w) -> (boxes (B, C, max_det, 4) [u0, v0, u1, v1] in
    image pixels, scores (B, C, max_det)), score-descending per class.
    ``nms_k`` (default 3 at stride 4, 5 at stride 2) keeps the suppression
    radius near 4 image px."""
    if nms_k is None:
        nms_k = 3 if stride >= 4 else 5
    B, C4, h, w = pred.shape
    C = C4 - 4
    hm = _local_max(torch.sigmoid(pred[:, :C]), nms_k)
    scores, idx = decode_ops._topk_iterative(hm.reshape(B, C, h * w), max_det)
    vi, ui = idx // w, idx % w
    flat = idx.reshape(B, 1, C * max_det).expand(B, 4, -1)
    reg = torch.gather(pred[:, C:].reshape(B, 4, h * w), 2, flat).reshape(B, 4, C, max_det)
    bw, bh, ou, ov = reg.unbind(1)
    cu = (ui.float() + ou) * stride
    cv = (vi.float() + ov) * stride
    bw = bw * stride
    bh = bh * stride
    return torch.stack([cu - bw / 2, cv - bh / 2, cu + bw / 2, cv + bh / 2], -1), scores
