"""Evaluation metrics: PCK and ADD (port of the JAX ``eval/metrics.py``).

* PCK@alpha: the fraction of visible keypoints predicted within
  ``alpha * max(bbox_w, bbox_h)`` pixels of the ground truth.
* ADD / ADD-0.1d: the mean 3D distance between model points under the
  estimated and the true pose; ADD-0.1d is the fraction of objects with ADD
  below 10% of the model diameter.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def pck(pred_uv: Tensor, gt_uv: Tensor, visible: Tensor, bbox_size: Tensor,
        alpha: float = 0.5) -> Tensor:
    """pred/gt (..., K, 2), visible (..., K), bbox_size (..., 2) (w, h) ->
    scalar PCK, with the threshold alpha * max(w, h) per object."""
    thresh = alpha * torch.amax(bbox_size, -1)
    d = torch.linalg.norm(pred_uv - gt_uv, dim=-1)
    ok = (d <= thresh[..., None]) & visible
    return torch.sum(ok) / torch.clamp_min(torch.sum(visible), 1)


def add_metric(R_pred: Tensor, t_pred: Tensor, R_gt: Tensor, t_gt: Tensor,
               model_points: Tensor) -> Tensor:
    """(..., 3, 3) / (..., 3) poses, model_points (..., N, 3) -> ADD (...,)."""
    p1 = torch.einsum("...ij,...nj->...ni", R_pred, model_points) + t_pred[..., None, :]
    p2 = torch.einsum("...ij,...nj->...ni", R_gt, model_points) + t_gt[..., None, :]
    return torch.mean(torch.linalg.norm(p1 - p2, dim=-1), -1)


def model_diameter(model_points: Tensor) -> Tensor:
    """The largest pairwise distance, (..., N, 3) -> (...,)."""
    d = torch.linalg.norm(model_points[..., :, None, :] - model_points[..., None, :, :], dim=-1)
    return torch.amax(d, (-1, -2))


def add_accuracy(add: Tensor, diameter: Tensor, valid: Tensor, frac: float = 0.1) -> Tensor:
    """ADD-0.1d: the fraction of valid objects with ADD < frac * diameter."""
    ok = (add < frac * diameter) & valid
    return torch.sum(ok) / torch.clamp_min(torch.sum(valid), 1)


def aabb_corners(aabb_min, aabb_max, device="cpu") -> Tensor:
    """A local AABB -> its 8 corners (8, 3): the ADD point set of an object
    whose keypoints do not span its geometry."""
    amin = torch.as_tensor(aabb_min, dtype=torch.float32, device=device)
    amax = torch.as_tensor(aabb_max, dtype=torch.float32, device=device)
    sel = torch.tensor([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                       dtype=torch.float32, device=device)
    return amin[None, :] * (1.0 - sel) + amax[None, :] * sel
