"""HRNet, the high-resolution pose backbone (Sun, Xiao, Liu, Wang, "Deep
High-Resolution Representation Learning for Human Pose Estimation", CVPR
2019, arXiv:1902.09212), in the layout of its official ``pose_hrnet.py``
(``github.com/leoxiaobin/deep-high-resolution-net.pytorch``), whose module
names it keeps but for the head.

* Stem: two 3x3 stride-2 convolutions to ``stem_features`` channels, each
  with BatchNorm and ReLU (stride 4).
* Stage 1 (``layer1``): ``blocks`` Bottleneck units of width
  ``stem_features``, giving 4x that many channels.
* Stages 2 to 4 hold ``stage_modules[1:]`` high-resolution modules over 2, 3
  and 4 parallel branches at strides 4, 8, 16 and 32, with ``width`` x 1,
  2, 4, 8 channels. A module runs ``blocks`` BasicBlocks on every branch,
  then fuses: branch i's output is the ReLU of the sum over branches j of
  ``x_j`` (j = i), of a 1x1 convolution, BatchNorm and nearest upsampling
  by 2^(j - i) (j > i), or of i - j 3x3 stride-2 convolutions with
  BatchNorm, a ReLU after every link but the last, the links before the
  last keeping branch j's width (j < i). The last module fuses into
  branch 0 alone.
* Transitions: stage 1's output goes to branch 0 through a 3x3
  convolution, BatchNorm and ReLU; each new branch comes from the previous
  stage's lowest branch through a 3x3 stride-2 one.
* ``head``: a 1x1 convolution with bias, ``width`` -> ``num_channels``, at
  stride 4 (the official ``final_layer``).

Convolutions pad ``k // 2`` and carry no bias (the head's aside);
BatchNorm has momentum 0.1 and eps 1e-5, and normalizes a training batch
by its own statistics (``.train()``), evaluation by the running ones
(``.eval()``). The body runs under bf16 autocast where ``dtype`` is
bfloat16, the head in f32 (``backbone._Backbone``).

Spans (``utils/profiling.annotate``; free with no profiler active):
``model.forward`` (the base class's) and ``model.exchange`` around each
transition and each module's fuse.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate as span
from .backbone import _Backbone

Tensor = torch.Tensor
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _bn(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, relu: bool = True) -> nn.Sequential:
    layers = [_conv(cin, cout, k, stride), _bn(cout)]
    return nn.Sequential(*layers, nn.ReLU(inplace=True)) if relu else nn.Sequential(*layers)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, cout, 1)
        self.bn3 = _bn(cout)
        self.downsample = _conv_bn(cin, cout, 1, relu=False) if cin != cout else None

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = F.relu(self.bn2(self.conv2(y)), inplace=True)
        y = self.bn3(self.conv3(y))
        skip = x if self.downsample is None else self.downsample(x)
        return F.relu(y + skip, inplace=True)


class BasicBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv(features, features, 3)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = _bn(features)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        return F.relu(self.bn2(self.conv2(y)) + x, inplace=True)


class _Upsampled(nn.Sequential):
    """A fuse term from a lower branch: 1x1 convolution, BatchNorm, then
    nearest upsampling by ``scale`` (the official ``nn.Upsample``, which
    holds no parameter)."""

    def __init__(self, cin: int, cout: int, scale: int):
        super().__init__(_conv(cin, cout, 1), _bn(cout))
        self.scale = scale

    def forward(self, x: Tensor) -> Tensor:
        return F.interpolate(super().forward(x), scale_factor=self.scale, mode="nearest")


def _fuse_term(widths: Sequence[int], i: int, j: int) -> nn.Module | None:
    """The term of branch j in the fuse into branch i (None: x_j as it is)."""
    if j > i:
        return _Upsampled(widths[j], widths[i], 2 ** (j - i))
    if j == i:
        return None
    links = [_conv_bn(widths[j], widths[j], 3, 2) for _ in range(i - j - 1)]
    return nn.Sequential(*links, _conv_bn(widths[j], widths[i], 3, 2, relu=False))


class HighResolutionModule(nn.Module):
    """``blocks`` BasicBlocks on each branch of ``widths``, then the fuse
    into every branch (into branch 0 alone where not ``multi_scale``)."""

    def __init__(self, widths: Sequence[int], blocks: int, multi_scale: bool = True):
        super().__init__()
        n = len(widths)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(w) for _ in range(blocks)]) for w in widths)
        self.fuse_layers = nn.ModuleList(
            nn.ModuleList(_fuse_term(widths, i, j) for j in range(n))
            for i in range(n if multi_scale else 1))

    def forward(self, xs: List[Tensor]) -> List[Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        with span("model.exchange"):
            out = []
            for terms in self.fuse_layers:
                y = None
                for term, x in zip(terms, xs):
                    t = x if term is None else term(x)
                    y = t if y is None else y + t
                out.append(F.relu(y, inplace=True))
            return out


def _transition(prev: Sequence[int], cur: Sequence[int]) -> nn.ModuleList:
    """Branch i of the new stage from branch i of the last (a 3x3
    convolution where the widths differ, else None) or, for a new branch,
    from the last one's lowest branch by a 3x3 stride-2 convolution."""
    layers = []
    for i, w in enumerate(cur):
        if i < len(prev):
            layers.append(_conv_bn(prev[i], w, 3) if prev[i] != w else None)
        else:
            layers.append(nn.Sequential(_conv_bn(prev[-1], w, 3, 2)))
    return nn.ModuleList(layers)


class HRNet(_Backbone):
    """HRNet-W``width`` with a 1x1 heatmap head; raw heatmaps at stride 4.
    ``stage_modules[0]`` is stage 1's one Bottleneck layer, the others the
    high-resolution modules of stages 2 on (the published (1, 1, 4, 3))."""

    output_stride = 4

    def __init__(self, num_channels: int, width: int = 48,
                 stage_modules: Sequence[int] = (1, 1, 4, 3), blocks: int = 4,
                 stem_features: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if len(stage_modules) < 2 or stage_modules[0] != 1:
            raise ValueError("HRNet: stage 1 is one Bottleneck layer (stage_modules[0] == 1) "
                             "and at least one high-resolution stage follows")
        self.num_channels = num_channels
        self.dtype = dtype
        self.conv1 = _conv(3, stem_features, 3, 2)
        self.bn1 = _bn(stem_features)
        self.conv2 = _conv(stem_features, stem_features, 3, 2)
        self.bn2 = _bn(stem_features)
        cout = stem_features * Bottleneck.expansion
        self.layer1 = nn.Sequential(*[Bottleneck(stem_features if b == 0 else cout,
                                                 stem_features) for b in range(blocks)])
        widths = [cout]
        for s, modules in enumerate(stage_modules[1:], start=2):
            cur = [width * 2 ** b for b in range(s)]
            self.add_module(f"transition{s - 1}", _transition(widths, cur))
            last = s == len(stage_modules)
            self.add_module(f"stage{s}", nn.Sequential(*[
                HighResolutionModule(cur, blocks, multi_scale=not (last and m == modules - 1))
                for m in range(modules)]))
            widths = cur
        self.stages = len(stage_modules)
        self.head = nn.Conv2d(width, num_channels, 1)

    def body(self, x: Tensor) -> Tensor:
        x = F.relu(self.bn1(self.conv1(x)), inplace=True)
        x = F.relu(self.bn2(self.conv2(x)), inplace=True)
        xs = [self.layer1(x)]
        for s in range(2, self.stages + 1):
            transition = getattr(self, f"transition{s - 1}")
            with span("model.exchange"):
                # a new branch (i past the last stage's) from the lowest one
                ins = [xs[min(i, len(xs) - 1)] for i in range(len(transition))]
                xs = [x if layer is None else layer(x) for layer, x in zip(transition, ins)]
            xs = getattr(self, f"stage{s}")(xs)
        return xs[0]
