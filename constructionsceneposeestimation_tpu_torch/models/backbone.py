"""Keypoint-heatmap backbones (port of the JAX ``models/backbone.py``).

Simple-Baselines style: a ResNet-ish encoder, stride-2 transposed-conv
upsampling with FPN-style 1x1 laterals, and a 1x1 head. NCHW ``nn.Module``s
that reproduce the flax modules layer for layer, so the flax parameters
carry over (``convert.pose_net_params``):

* flax ``padding="SAME"`` pads asymmetrically on even inputs at stride 2
  ((2, 3) for 7x7, (0, 1) for 3x3), so convolutions pad explicitly
  (``_same_pad``) rather than with ``padding=k // 2``;
* the stem's SAME max-pool pads with -inf;
* GroupNorm uses flax's eps 1e-6 and ``min(32, features)`` groups;
* ``dtype=torch.bfloat16`` (the default, as in flax) runs the body under
  bf16 autocast; the head always runs in f32.

``_Backbone.forward`` opens the span ``model.forward`` around the body and
the head (``utils/profiling.annotate``: a flag check with no profiler
active), as every backbone built on it does (``models/hrnet.py`` too).

The convolutions are cuDNN's: the JAX package leaves them to XLA, outside
any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate as span

Tensor = torch.Tensor
GN_EPS = 1e-6


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax/XLA "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax "SAME" padding, no bias unless asked."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = False):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        ph = _same_pad(x.shape[-2], k, s)
        pw = _same_pad(x.shape[-1], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, s, (ph[0], pw[0]))
        return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), self.weight, self.bias, s)


def _max_pool_same(x: Tensor, k: int = 3, stride: int = 2) -> Tensor:
    ph = _same_pad(x.shape[-2], k, stride)
    pw = _same_pad(x.shape[-1], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def _group_norm(features: int, groups: int | None = None) -> nn.GroupNorm:
    return nn.GroupNorm(groups or min(32, features), features, eps=GN_EPS)


def _deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """flax ``ConvTranspose((4, 4), (2, 2))``, SAME: the output doubles."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=False)


class ResBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(cin, features, 3, stride)
        self.norm1 = _group_norm(features)
        self.conv2 = SameConv2d(features, features, 3)
        self.norm2 = _group_norm(features)
        self.proj = self.proj_norm = None
        if cin != features or stride != 1:
            self.proj = SameConv2d(cin, features, 1, stride)
            self.proj_norm = _group_norm(features)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.proj is not None:
            x = self.proj_norm(self.proj(x))
        return F.relu(y + x)


class _Backbone(nn.Module):
    """The bf16-body / f32-head split shared by both backbones."""

    dtype: torch.dtype
    head: nn.Conv2d

    def body(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def forward(self, x: Tensor) -> Tensor:
        """images (B, 3, H, W) f32 -> raw heatmaps (B, C, H/s, W/s) f32."""
        with span("model.forward"):
            with torch.autocast(x.device.type, dtype=torch.bfloat16,
                                enabled=self.dtype == torch.bfloat16):
                x = self.body(x)
            with torch.autocast(x.device.type, enabled=False):
                return self.head(x.float())


class HeatmapBackbone(_Backbone):
    def __init__(self, num_channels: int,
                 stage_features: Sequence[int] = (64, 128, 256, 512),
                 blocks_per_stage: Sequence[int] = (2, 2, 2, 2),
                 deconv_features: int = 256, output_stride: int = 4,
                 use_skips: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if output_stride not in (2, 4):
            raise ValueError("output_stride must be 2 or 4")
        self.num_channels = num_channels
        self.output_stride = output_stride
        self.use_skips = use_skips
        self.dtype = dtype
        self.stem = SameConv2d(3, 64, 7, 2)
        self.stem_norm = _group_norm(64, 32)
        blocks, self.stage_ends, cin = [], [], 64
        for i, (feats, n) in enumerate(zip(stage_features, blocks_per_stage)):
            for b in range(n):
                blocks.append(ResBlock(cin, feats, 2 if (b == 0 and i > 0) else 1))
                cin = feats
            self.stage_ends.append(len(blocks) - 1)
        self.blocks = nn.ModuleList(blocks)
        n_deconv = 3 if output_stride == 4 else 4
        lateral_in = [stage_features[2], stage_features[1], stage_features[0], 64]
        self.deconvs = nn.ModuleList()
        self.laterals = nn.ModuleList()
        self.dec_norms = nn.ModuleList()
        for d in range(n_deconv):
            self.deconvs.append(_deconv(cin, deconv_features))
            if use_skips:
                self.laterals.append(SameConv2d(lateral_in[d], deconv_features, 1))
            self.dec_norms.append(_group_norm(deconv_features, 32))
            cin = deconv_features
        self.head = nn.Conv2d(deconv_features, num_channels, 1)

    def body(self, x: Tensor) -> Tensor:
        x = F.relu(self.stem_norm(self.stem(x)))
        stem2 = x  # /2
        x = _max_pool_same(x)
        skips = []  # stage outputs at /4, /8, /16, /32
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in self.stage_ends:
                skips.append(x)
        lateral_src = [skips[2], skips[1], skips[0], stem2]
        for d, deconv in enumerate(self.deconvs):
            x = deconv(x)
            if self.use_skips:
                x = x + self.laterals[d](lateral_src[d])
            x = F.relu(self.dec_norms[d](x))
        return x


class LiteBackbone(_Backbone):
    """The small stride-4 variant."""

    output_stride = 4

    def __init__(self, num_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_channels = num_channels
        self.dtype = dtype
        self.stem = SameConv2d(3, 32, 7, 2)
        self.stem_norm = _group_norm(32, 8)
        self.blocks = nn.ModuleList([ResBlock(32, 64, 2), ResBlock(64, 128, 2)])
        self.deconvs = nn.ModuleList([_deconv(128, 128)])
        self.dec_norms = nn.ModuleList([_group_norm(128, 32)])
        self.head = nn.Conv2d(128, num_channels, 1)

    def body(self, x: Tensor) -> Tensor:
        x = F.relu(self.stem_norm(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        return F.relu(self.dec_norms[0](self.deconvs[0](x)))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """flax's default initialization, drawn from a CPU generator seeded with
    ``seed`` (so the weights do not depend on the device): kernels
    LeCun-normal (a normal truncated at 2 std, std sqrt(1 / fan_in) / 0.8796),
    biases 0, GroupNorm's and BatchNorm's scale 1 and bias 0, BatchNorm's
    running mean 0, running variance 1 and count of batches 0."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            kh, kw = w.shape[-2:]
            cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
            std = math.sqrt(1.0 / (kh * kw * cin)) / 0.87962566103423978
            sample = torch.empty(w.shape)
            nn.init.trunc_normal_(sample, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            w.copy_(sample)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return model
