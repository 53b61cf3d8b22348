"""Heatmap -> keypoint decoding (port of the JAX ``ops/decode.py``).

* ``soft_argmax``: the background-suppressed spatial expectation.
* ``dark_decode``: hard argmax + DARK Taylor refinement on the log of the
  3x3-blurred heatmap (Zhang et al. 2020).
* ``extract_peaks``: the top-K 3x3 local maxima per channel with DARK
  refinement, for class-level channels that carry one blob per instance.
  A CUDA tensor launches the peak kernel (``ops/peak_kernel.py``,
  ``csrc/peaks.cu``); a CPU tensor takes its plain version.
* ``associate_peaks``: peaks routed to instances by their 2D boxes.
* ``_topk_iterative``: exact top-k of non-negative rows by k rounds of
  max, argmax and suppression (the detector's decode).

The TPU-only top-K machinery of the JAX module (2x2 block packing with a
mantissa payload, one-hot einsums in place of gathers) is not carried
over: the port gathers.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def soft_argmax(heatmaps: Tensor, temperature: float | None = None):
    """(..., C, H, W) -> (uv (..., C, 2) in heatmap pixels, score (..., C)).

    ``temperature=None`` takes the linear expectation of the map after its
    minimum is subtracted and values below 20% of its peak are zeroed;
    a float ``temperature`` takes a softmax instead."""
    *_, H, W = heatmaps.shape
    flat = heatmaps.reshape(*heatmaps.shape[:-2], H * W)
    if temperature is None:
        base = flat - torch.amin(flat, -1, keepdim=True)
        pos = torch.clamp_min(base - 0.2 * torch.amax(base, -1, keepdim=True), 0.0)
        p = pos / torch.clamp_min(torch.sum(pos, -1, keepdim=True), 1e-9)
    else:
        p = torch.softmax(temperature * flat, dim=-1)
    xs = torch.arange(W, dtype=torch.float32, device=flat.device)
    ys = torch.arange(H, dtype=torch.float32, device=flat.device)
    u = torch.sum(p * xs.repeat(H), -1)
    v = torch.sum(p * ys.repeat_interleave(W), -1)
    return torch.stack([u, v], -1), torch.amax(flat, -1)


def _edge_pad(x: Tensor, dim: int) -> Tensor:
    """Pad one row or column on each side of ``dim`` (-2 or -1) by
    repeating the edge."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim)


def _gaussian_blur_3x3(h: Tensor) -> Tensor:
    """Separable [1 2 1]/4 blur, edge-padded, rows first. The sums run left
    to right in f32 (the CUDA peak kernel repeats this order bit for bit)."""
    hp = _edge_pad(h, -2)
    h1 = 0.25 * hp[..., :-2, :] + 0.5 * hp[..., 1:-1, :] + 0.25 * hp[..., 2:, :]
    hp = _edge_pad(h1, -1)
    return 0.25 * hp[..., :, :-2] + 0.5 * hp[..., :, 1:-1] + 0.25 * hp[..., :, 2:]


def _max_pool_3x3(h: Tensor) -> Tensor:
    """3x3 max-pool with edge clamp, as two separable 3-taps."""
    hp = _edge_pad(h, -2)
    m = torch.maximum(torch.maximum(hp[..., :-2, :], hp[..., 1:-1, :]), hp[..., 2:, :])
    hp = _edge_pad(m, -1)
    return torch.maximum(torch.maximum(hp[..., :, :-2], hp[..., :, 1:-1]), hp[..., :, 2:])


def _extract_neighborhoods(hm: Tensor, py: Tensor, px: Tensor, radius: int = 1) -> Tensor:
    """(2r+1)^2 neighbourhoods of ``hm`` (..., H, W) at integer (py, px)
    (..., P), indices clamped to the map (edge padding) -> (..., P, 2r+1,
    2r+1), layout [dy, dx] with the centre at [r, r]. A gather."""
    *lead, H, W = hm.shape
    P = py.shape[-1]
    n = 2 * radius + 1
    off = torch.arange(-radius, radius + 1, device=py.device)
    ry = torch.clamp(py.long()[..., None] + off, 0, H - 1)  # (..., P, n)
    rx = torch.clamp(px.long()[..., None] + off, 0, W - 1)
    idx = (ry[..., :, None] * W + rx[..., None, :]).reshape(*lead, P * n * n)
    return torch.gather(hm.reshape(*lead, H * W), -1, idx).reshape(*lead, P, n, n)


def _dark_refine(nb: Tensor, py: Tensor, px: Tensor, H: int, W: int, eps: float = 1e-8):
    """DARK offsets from blurred 3x3 neighbourhoods (..., P, 3, 3):
    mu = peak - Hess^-1 grad on the log surface, zeroed at borders, at
    non-concave points and where an offset exceeds a pixel. The operations
    run one at a time in f32; the CUDA peak kernel repeats their order."""
    ln = torch.log(torch.clamp_min(nb, eps))
    dx = 0.5 * (ln[..., 1, 2] - ln[..., 1, 0])
    dy = 0.5 * (ln[..., 2, 1] - ln[..., 0, 1])
    dxx = ln[..., 1, 2] - 2.0 * ln[..., 1, 1] + ln[..., 1, 0]
    dyy = ln[..., 2, 1] - 2.0 * ln[..., 1, 1] + ln[..., 0, 1]
    dxy = 0.25 * (ln[..., 2, 2] - ln[..., 2, 0] - ln[..., 0, 2] + ln[..., 0, 0])
    det = dxx * dyy - dxy * dxy
    det_safe = torch.where(torch.abs(det) < eps, torch.sign(det) * eps + eps, det)
    off_x = -(dyy * dx - dxy * dy) / det_safe
    off_y = -(dxx * dy - dxy * dx) / det_safe
    interior = (px > 0) & (px < W - 1) & (py > 0) & (py < H - 1)
    sane = (dxx < 0) & (dyy < 0) & (torch.abs(off_x) < 1.0) & (torch.abs(off_y) < 1.0)
    ok = interior & sane
    return torch.where(ok, off_x, 0.0), torch.where(ok, off_y, 0.0)


def dark_decode(heatmaps: Tensor, blur: bool = True, eps: float = 1e-8):
    """(..., C, H, W) -> (uv (..., C, 2), score (..., C)): the argmax of the
    blurred map, refined by DARK; the score is the raw map's maximum."""
    *_, H, W = heatmaps.shape
    hm = _gaussian_blur_3x3(heatmaps) if blur else heatmaps
    idx = torch.argmax(hm.reshape(*hm.shape[:-2], H * W), -1)
    score = torch.amax(heatmaps.reshape(*heatmaps.shape[:-2], H * W), -1)
    py, px = idx // W, idx % W
    nb = _extract_neighborhoods(hm, py[..., None], px[..., None])[..., 0, :, :]
    off_x, off_y = _dark_refine(nb, py, px, H, W, eps)
    return torch.stack([px + off_x, py + off_y], -1), score


def extract_peaks(heatmaps: Tensor, max_peaks: int = 8, blur: bool = True, eps: float = 1e-8):
    """(..., H, W) -> (uv (..., K, 2), scores (..., K)), score-descending:
    top-K 3x3 local maxima of the relu'd, blurred map with DARK refinement;
    scores are the raw amplitude. Fewer than K positive peaks repeat the
    first pixel with score 0. A CUDA tensor launches the peak kernel, a CPU
    tensor takes its plain version."""
    from . import peak_kernel

    if heatmaps.is_cuda:
        return peak_kernel.peaks_cuda(heatmaps.float().contiguous(), max_peaks, blur, eps)
    return peak_kernel.extract_peaks_plain(heatmaps, max_peaks, blur, eps)


def associate_peaks(uv_pk: Tensor, sc_pk: Tensor, channels: Tensor, bbox2d: Tensor,
                    margin: float = 8.0):
    """Route class-level peaks to instances: each (instance, keypoint) slot
    takes the best peak of its channel inside the instance's 2D box grown
    by ``margin`` px.

    uv_pk (..., C, P, 2) full-resolution peaks, sc_pk (..., C, P),
    channels (O, K) with -1 padding, bbox2d (..., O, 4) ([-1] * 4 if
    unseen) -> (uv (..., O, K, 2), score (..., O, K)); score 0 where no
    peak of the right channel lands in the box."""
    O, K = channels.shape
    ch_flat = torch.clamp_min(channels, 0).reshape(-1).long()
    pk = uv_pk.index_select(-3, ch_flat)  # (..., O*K, P, 2)
    sc = sc_pk.index_select(-2, ch_flat)  # (..., O*K, P)
    lead = pk.shape[:-3]
    pk = pk.reshape(*lead, O, K, *pk.shape[-2:])
    sc = sc.reshape(*lead, O, K, sc.shape[-1])
    box = bbox2d[..., :, None, None, :]
    u, v = pk[..., 0], pk[..., 1]
    inside = ((u >= box[..., 0] - margin) & (u <= box[..., 2] + margin)
              & (v >= box[..., 1] - margin) & (v <= box[..., 3] + margin)
              & (box[..., 2] >= 0))
    sc_gated = torch.where(inside & (channels >= 0)[..., None], sc, 0.0)
    best = torch.argmax(sc_gated, -1, keepdim=True)  # (..., O, K, 1)
    uv = torch.take_along_dim(pk, best[..., None], -2)[..., 0, :]
    return uv, torch.take_along_dim(sc_gated, best, -1)[..., 0]


def _topk_iterative(flat: Tensor, k: int):
    """Top-k of non-negative rows (..., n) -> (values (..., k), indices
    (..., k)) by k rounds of max, argmax and suppress-to-0, as the JAX
    function does: the argmax takes the first index on ties, so a row with
    fewer than k non-zero entries repeats index 0 with value 0 (``torch.topk``
    does not fix the order of ties)."""
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(flat, -1)
        vals.append(torch.amax(flat, -1))
        idxs.append(i)
        flat = flat.scatter(-1, i[..., None], 0.0)
    return torch.stack(vals, -1), torch.stack(idxs, -1)
