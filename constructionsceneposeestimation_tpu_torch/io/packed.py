"""Packed binary dataset format (production path).

The reference's text formats (depth CSV ~1.5 MB/frame, pointcloud txt
~8 MB/frame) are kept for drop-in parity (io/writers.py), but at the card's
rates serialization must be binary: one ``shard_%06d.npz`` per batch holding every
modality as arrays, ~10x smaller and ~50x faster to write/read. Pointclouds
are not stored — they are derivable exactly from (depth, rgb, camera_pose)
via the documented backprojection, which is the point of emitting a correct
camera_pose.

A copy of the JAX package's ``io/packed.py``: the same arrays, dtypes,
keys and manifest bytes. ``save_shard`` takes a host batch (numpy arrays or
CPU tensors; ``parallel/pipeline.HostCopy`` copies one off the card).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List

import numpy as np

from ..scene import taxonomy


def save_shard(path: str, batch, roster, compress: bool = False) -> None:
    """FrameBatch -> one npz shard. Labels stay queryable: per-frame object
    validity is `inst_visible`; class ids/prim paths come from the manifest."""
    arrays = {
        "frame_id": np.asarray(batch.frame_id),
        "rgb": np.asarray(batch.rgb),
        "depth": np.asarray(batch.depth, np.float32),
        "instance": np.asarray(batch.instance, np.int32),
        "camera_pose7": np.asarray(batch.camera_pose7, np.float32),
        "inst_visible": np.asarray(batch.inst_visible),
        "inst_pixel_count": np.asarray(batch.inst_pixel_count, np.int32),
        "bbox2d": np.asarray(batch.bbox2d, np.int32),
        "center": np.asarray(batch.center, np.float32),
        "size": np.asarray(batch.size, np.float32),
        "euler_deg": np.asarray(batch.euler_deg, np.float32),
        "kpt_uv": np.asarray(batch.kpt_uv, np.float32),
        "kpt_visible": np.asarray(batch.kpt_visible),
        "pointcloud_count": np.asarray(batch.pointcloud_count, np.int32),
    }
    hm = np.asarray(batch.heatmaps)
    if hm.shape[1] > 0:
        arrays["heatmaps"] = hm.astype(np.float16)
    save = np.savez_compressed if compress else np.savez
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        save(f, **arrays)
    os.replace(tmp, path)


def save_manifest(root: str, roster, cfg) -> None:
    """Dataset-level static metadata (written once)."""
    meta = {
        "class_mapping": dict(taxonomy.CONSTRUCTION_CLASS),
        "inst_class_ids": [int(c) for c in roster.inst_class_id],
        "inst_class_names": list(roster.inst_class_names),
        "inst_prim_paths": list(roster.inst_prim_paths),
        "camera": {
            "focal_length": cfg.camera.focal_length,
            "horizontal_aperture": cfg.camera.horizontal_aperture,
            "width": cfg.pipeline.render_width,
            "height": cfg.pipeline.render_height,
        },
        "heatmap": {
            "stride": cfg.pipeline.heatmap_stride,
            "sigma": cfg.pipeline.heatmap_sigma,
        },
    }
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "dataset_manifest.json"), "w") as f:
        json.dump(meta, f, indent=2)


def shard_paths(root: str) -> List[str]:
    return sorted(
        os.path.join(root, f) for f in os.listdir(root)
        if f.startswith("shard_") and f.endswith(".npz")
    )


def iter_shards(root: str) -> Iterator[Dict[str, np.ndarray]]:
    for p in shard_paths(root):
        with np.load(p) as z:
            yield {k: z[k] for k in z.files}
