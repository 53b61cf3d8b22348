"""Training losses for heatmap regression (port of the JAX
``train/losses.py``)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """``jnp.clip``, gradient included: a value on a bound passes half the
    gradient (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _focal_terms(pred: Tensor, target: Tensor, alpha: float, beta: float, eps: float,
                 channel_weights: Tensor | None, channel_dim: int):
    """Elementwise positive and negative focal terms and the positive mask;
    ``channel_weights`` (C,) scale both terms along ``channel_dim``."""
    p = _clip(torch.sigmoid(pred), eps, 1.0 - eps)
    pos = (target > 0.9).to(pred.dtype)
    neg_w = torch.pow(1.0 - target, beta)
    pos_loss = -torch.pow(1.0 - p, alpha) * torch.log(p) * pos
    neg_loss = -torch.pow(p, alpha) * torch.log(1.0 - p) * neg_w * (1.0 - pos)
    if channel_weights is not None:
        w = channel_weights.reshape(channel_weights.shape + (1,) * (pred.ndim - 1 - channel_dim))
        pos_loss = pos_loss * w
        neg_loss = neg_loss * w
    return pos_loss, neg_loss, pos


def focal_heatmap_loss(pred: Tensor, target: Tensor, alpha: float = 2.0, beta: float = 4.0,
                       eps: float = 1e-6, channel_weights: Tensor | None = None,
                       n_pos: Tensor | None = None) -> Tensor:
    """CenterNet-style penalty-reduced focal loss on logits ``pred``;
    ``channel_weights`` (C,) scales each leading-axis channel's positive and
    negative terms. ``n_pos``, the positives the sum is divided by, defaults
    to those of ``target``; a data-parallel rank passes the global count."""
    pos_loss, neg_loss, pos = _focal_terms(pred, target, alpha, beta, eps, channel_weights, 0)
    n_pos = torch.clamp_min(torch.sum(pos) if n_pos is None else n_pos, 1.0)
    return (torch.sum(pos_loss) + torch.sum(neg_loss)) / n_pos


