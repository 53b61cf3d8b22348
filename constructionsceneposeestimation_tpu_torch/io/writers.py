"""Per-modality file writers matching the reference's on-disk formats.

  rgb_%06d.png          PNG image (reference: cv2.imwrite at 1672-1673; the
                        reference saves BGR-converted data with cv2, which
                        writes RGB-ordered PNG bytes — so a plain RGB PNG here
                        is byte-format-compatible)
  depth_%06d.csv        np.savetxt('%.6f', ' ') raw depth rows (1687-1688)
  depth_%06d.png        min-max-normalized JET colormap viz (1690-1709)
  pointcloud_%06d.txt   'x y z r g b' header + %.6f rows (769-770)
  label_%06d.json       see io/schema.py
  instance_mask_%06d.npy int32 (H, W); parity mode fills -1 (1908-1910),
                        else the real instance ids from the renderer

A copy of the JAX package's ``io/writers.py``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import native, schema


def save_rgb_png(path: str, rgb: np.ndarray, level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(native.encode_png_rgb8(rgb, level))


def save_depth_csv(path: str, depth: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(native.format_floats_6f(depth))


def depth_viz_png_bytes(depth: np.ndarray) -> bytes:
    """Reference depth visualization (1690-1709): min-max normalize the valid
    pixels, JET-colormap, zeros elsewhere; all-invalid -> black image."""
    valid = np.isfinite(depth) & (depth > 0)
    h, w = depth.shape
    if valid.any():
        dmin = float(depth[valid].min())
        dmax = float(depth[valid].max())
        norm = np.zeros((h, w), np.uint8)
        norm[valid] = ((depth[valid] - dmin) / (dmax - dmin + 1e-6) * 255).astype(np.uint8)
        bgr = native.jet_colormap(norm)
        rgb = bgr[..., ::-1]  # PNG stores RGB; cv2 wrote BGR arrays as RGB files
    else:
        rgb = np.zeros((h, w, 3), np.uint8)
    return native.encode_png_rgb8(np.ascontiguousarray(rgb))


def save_depth_png(path: str, depth: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(depth_viz_png_bytes(depth))


def save_pointcloud(path: str, xyzrgb: np.ndarray) -> None:
    """(N, 6) -> text with 'x y z r g b' header (reference 769-770)."""
    with open(path, "wb") as f:
        f.write(native.format_floats_6f(xyzrgb, header="x y z r g b"))


def save_instance_mask(path: str, instance: Optional[np.ndarray],
                       height: int, width: int, parity: bool = False) -> None:
    """Reference writes a -1-filled placeholder (1908-1910, 2066-2069);
    default here is the REAL instance map (sky -2 also mapped to -1 to keep
    the reference's 'unlabeled = -1' convention)."""
    if parity or instance is None:
        mask = np.full((height, width), -1, np.int32)
    else:
        mask = np.asarray(instance, np.int32).copy()
        mask[mask < 0] = -1
    np.save(path, mask)


def ensure_dataset_dirs(root: str) -> dict:
    """Create the reference output tree (1350-1355)."""
    dirs = {
        "root": root,
        "rgb": os.path.join(root, "rgb"),
        "depth": os.path.join(root, "depth"),
        "pointcloud": os.path.join(root, "pointcloud"),
        "labels": os.path.join(root, "labels"),
        "logs": os.path.join(root, "logs"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs
