"""Visualization helpers on the host, in numpy (a copy of the JAX
package's ``utils/viz.py``): keypoints and their visibility and heatmap
channels over rendered frames, and PNGs through the port's own encoder
(``io/native.encode_png_rgb8``). No plotting dependencies.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..io import native

CLASS_COLORS = np.asarray([
    [255, 140, 0],   # trafficcone
    [60, 180, 75],   # tree
    [145, 145, 155], # fence
    [230, 25, 75],   # crane
    [255, 225, 25],  # dumper
    [0, 130, 200],   # human
    [230, 25, 75],   # cranebase
    [220, 60, 100],  # cranecolumn
    [240, 50, 50],   # craneboom
    [250, 90, 30],   # cranetelescopic
], np.uint8)


def _disk(img: np.ndarray, u: float, v: float, color, r: int = 2) -> None:
    h, w = img.shape[:2]
    x0, x1 = max(int(u) - r, 0), min(int(u) + r + 1, w)
    y0, y1 = max(int(v) - r, 0), min(int(v) + r + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (xx - u) ** 2 + (yy - v) ** 2 <= r * r
    img[y0:y1, x0:x1][mask] = color


def overlay_keypoints(rgb: np.ndarray, kpt_uv: np.ndarray, kpt_visible: np.ndarray,
                      class_ids: np.ndarray, kpt_in_image: Optional[np.ndarray] = None,
                      radius: int = 2) -> np.ndarray:
    """rgb (H, W, 3) u8; kpt_uv (O, K, 2); visible/in_image (O, K);
    class_ids (O,). Visible keypoints: class color; occluded-but-in-image:
    dimmed."""
    out = np.asarray(rgb).copy()
    kpt_uv = np.asarray(kpt_uv)
    vis = np.asarray(kpt_visible)
    in_img = np.asarray(kpt_in_image) if kpt_in_image is not None else vis
    for o in range(kpt_uv.shape[0]):
        color = CLASS_COLORS[int(class_ids[o]) % len(CLASS_COLORS)]
        for k in range(kpt_uv.shape[1]):
            if vis[o, k]:
                _disk(out, kpt_uv[o, k, 0], kpt_uv[o, k, 1], color, radius)
            elif in_img[o, k]:
                _disk(out, kpt_uv[o, k, 0], kpt_uv[o, k, 1], color // 3, radius)
    return out


def heatmap_overlay(rgb: np.ndarray, heatmaps: np.ndarray,
                    channels: Optional[Sequence[int]] = None,
                    alpha: float = 0.6) -> np.ndarray:
    """Blend the max over selected channels (C, h, w) onto rgb (H, W, 3)."""
    rgb = np.asarray(rgb).astype(np.float32)
    hm = np.asarray(heatmaps)
    if channels is not None:
        hm = hm[list(channels)]
    m = hm.max(0)
    H, W = rgb.shape[:2]
    # Nearest-neighbor upsample to the image size.
    ys = (np.arange(H) * m.shape[0] // H).clip(0, m.shape[0] - 1)
    xs = (np.arange(W) * m.shape[1] // W).clip(0, m.shape[1] - 1)
    m_up = m[np.ix_(ys, xs)]
    heat = np.stack([m_up * 255, m_up * 30, (1 - m_up) * 60], -1)
    out = rgb * (1 - alpha * m_up[..., None]) + heat * (alpha * m_up[..., None])
    return np.clip(out, 0, 255).astype(np.uint8)


def save_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(native.encode_png_rgb8(np.ascontiguousarray(rgb)))
