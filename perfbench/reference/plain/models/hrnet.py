"""HRNet in plain PyTorch and float32, written from the paper (Sun, Xiao,
Liu, Wang, "Deep High-Resolution Representation Learning for Human Pose
Estimation", CVPR 2019, arXiv:1902.09212, section 3 and figure 2) and the
layout of its official ``pose_hrnet.py``
(github.com/leoxiaobin/deep-high-resolution-net.pytorch, configuration
``experiments/coco/hrnet/w48_384x288_adam_lr1e-3.yaml``). It imports
nothing but ``torch``.

The network, for widths C = ``width`` and a frame of H x W:

* stem: conv 3x3 stride 2 -> BN -> ReLU, twice, to ``stem_features``
  channels at H/4 (``conv1``, ``bn1``, ``conv2``, ``bn2``);
* stage 1 (``layer1``): ``blocks`` bottleneck units (1x1, 3x3, 1x1 with
  BN, ReLU between, a 1x1 BN projection on the first unit's shortcut),
  width ``stem_features``, out 4 x ``stem_features`` channels;
* stage s = 2, 3, 4: the transition makes s branches at H/4 ... H/2^(s+1)
  with C, 2C, ..., 2^(s-1) C channels (branch i < s-1 from the old branch
  i, through conv 3x3 -> BN -> ReLU where the width changes; the new
  branch from the old lowest through conv 3x3 stride 2 -> BN -> ReLU),
  then ``stage_modules[s-1]`` exchange units, each ``blocks`` residual units
  (conv 3x3 -> BN -> ReLU -> conv 3x3 -> BN, + input, ReLU) on every branch
  and the exchange: out_i = ReLU(sum_j a(x_j, i)), where a is x_j for
  j = i; conv 1x1 -> BN -> nearest upsampling by 2^(j-i) for j > i; and
  i - j convs 3x3 stride 2 with BN for j < i, ReLU between them, the ones
  before the last at branch j's width. The last unit of the last stage
  makes branch 0 only;
* ``head``: conv 1x1 with bias to the heatmap channels, at H/4.

BN: batch statistics in training mode, momentum 0.1, eps 1e-5. Every
convolution but the head's has no bias and pads k // 2. Parameters carry
the official names (the head aside), in the official order, so the same
seed draws the same weights here and in the program.

The whole batch goes through in one forward (BN's statistics are over
it): 32 frames of 512^2 peak at 36.1 GB on an H100, so nothing is
recomputed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM, EPS = 0.1, 1e-5


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def _norm(c):
    return nn.BatchNorm2d(c, eps=EPS, momentum=MOMENTUM)


def _pair(cin, cout, k, stride=1):
    """conv then BN, as modules "0" and "1"."""
    return nn.Sequential(_conv(cin, cout, k, stride), _norm(cout))


def _cbn(pair, x):
    return pair[1](pair[0](x))


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, project):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 1), _norm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _norm(planes)
        self.conv3, self.bn3 = _conv(planes, 4 * planes, 1), _norm(4 * planes)
        if project:
            self.downsample = _pair(cin, 4 * planes, 1)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        short = _cbn(self.downsample, x) if hasattr(self, "downsample") else x
        return torch.relu(h + short)


class Residual(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1, self.bn1 = _conv(c, c, 3), _norm(c)
        self.conv2, self.bn2 = _conv(c, c, 3), _norm(c)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(h)) + x)


def _nearest_up(x, k):
    """Nearest upsampling by the whole factor k: each value repeated k x k."""
    return x.repeat_interleave(k, dim=2).repeat_interleave(k, dim=3)


class Unit(nn.Module):
    """One exchange unit over the branch widths ``cs``; ``outs`` branches
    out."""

    def __init__(self, cs, blocks, outs):
        super().__init__()
        self.cs = list(cs)
        self.branches = nn.ModuleList(nn.Sequential(*[Residual(c) for _ in range(blocks)])
                                      for c in cs)
        rows = []
        for i in range(outs):
            row = nn.ModuleList()
            for j, c in enumerate(cs):
                if j > i:
                    row.append(_pair(c, cs[i], 1))
                elif j < i:
                    row.append(nn.Sequential(*[_pair(c, cs[i] if k == i - j - 1 else c, 3, 2)
                                               for k in range(i - j)]))
                else:
                    row.append(None)
            rows.append(row)
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, *xs):
        xs = [b(x) for b, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            total = 0
            for j, x in enumerate(xs):
                if j > i:
                    a = _nearest_up(_cbn(row[j], x), 2 ** (j - i))
                elif j < i:
                    a = x
                    for k, link in enumerate(row[j]):
                        a = _cbn(link, a)
                        if k < i - j - 1:
                            a = torch.relu(a)
                else:
                    a = x
                total = total + a
            outs.append(torch.relu(total))
        return tuple(outs)


class HRNet(nn.Module):
    output_stride = 4

    def __init__(self, num_channels, width=48, stage_modules=(1, 1, 4, 3), blocks=4,
                 stem_features=64):
        super().__init__()
        if stage_modules[0] != 1:
            raise ValueError("stage 1 is one layer of bottleneck units")
        self.conv1, self.bn1 = _conv(3, stem_features, 3, 2), _norm(stem_features)
        self.conv2, self.bn2 = _conv(stem_features, stem_features, 3, 2), _norm(stem_features)
        c1 = 4 * stem_features
        self.layer1 = nn.Sequential(*[Bottleneck(c1 if b else stem_features, stem_features,
                                                 project=b == 0) for b in range(blocks)])
        self.n_stages = len(stage_modules)
        old = [c1]
        for s in range(2, self.n_stages + 1):
            cs = [width * 2 ** b for b in range(s)]
            trans = nn.ModuleList()
            for i, c in enumerate(cs):
                if i >= len(old):
                    trans.append(nn.Sequential(nn.Sequential(_conv(old[-1], c, 3, 2), _norm(c))))
                elif old[i] != c:
                    trans.append(_pair(old[i], c, 3))
                else:
                    trans.append(None)
            setattr(self, f"transition{s - 1}", trans)
            n = stage_modules[s - 1]
            last = s == self.n_stages
            setattr(self, f"stage{s}", nn.Sequential(*[
                Unit(cs, blocks, 1 if last and u == n - 1 else s) for u in range(n)]))
            old = cs
        self.head = nn.Conv2d(width, num_channels, 1, bias=True)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        xs = (self.layer1(x),)
        for s in range(2, self.n_stages + 1):
            trans = getattr(self, f"transition{s - 1}")
            new = []
            for i, t in enumerate(trans):
                if t is None:
                    new.append(xs[i])
                elif i >= len(xs):
                    new.append(torch.relu(_cbn(t[0], xs[-1])))
                else:
                    new.append(torch.relu(_cbn(t, xs[i])))
            xs = tuple(new)
            for unit in getattr(self, f"stage{s}"):
                xs = unit(*xs)
        return self.head(xs[0])
