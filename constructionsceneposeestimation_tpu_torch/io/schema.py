"""Label JSON schema — bit-compatible with the reference generator.

Field set, key order, and formatting match ``label_data`` exactly
(generate_construction_data.py:2056-2064):

  frame_id, camera_pose [x y z qx qy qz qw], camera_params {...},
  objects [{inst_idx, class_id, class_name, center, size, rotation,
  prim_path}], instance_mask_shape [H, W], num_objects, class_mapping

written with ``json.dump(indent=2, ensure_ascii=False)`` (save_label_json,
608-613). ``objects`` entries follow pose_info key order (1938-1946);
``class_mapping`` is the full construction_class dict in source order (2063).
Values are plain Python floats (numpy ``.tolist()`` semantics in the
reference), so byte-level output equality holds for equal values. A copy of
the JAX package's ``io/schema.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

import numpy as np

from ..scene import taxonomy


def camera_params_dict(focal_length: float, horizontal_aperture: float,
                       width: int, height: int) -> Dict[str, Any]:
    """cam_params exactly as assembled at reference 2036-2045."""
    return {
        "horizontal_aperture": float(horizontal_aperture),
        "vertical_aperture": float(horizontal_aperture) * (height / width),
        "focal_length": float(focal_length),
        "width": int(width),
        "height": int(height),
    }


def object_entry(inst_idx: int, class_id: int, class_name: str,
                 center: Sequence[float], size: Sequence[float],
                 rotation: Sequence[float], prim_path: str) -> Dict[str, Any]:
    """pose_info key order (reference 1938-1946)."""
    return {
        "inst_idx": int(inst_idx),
        "class_id": int(class_id),
        "class_name": str(class_name),
        "center": [float(v) for v in center],
        "size": [float(v) for v in size],
        "rotation": [float(v) for v in rotation],
        "prim_path": str(prim_path),
    }


def label_dict(frame_id: int, camera_pose7: Sequence[float],
               camera_params: Dict[str, Any], objects: List[Dict[str, Any]],
               mask_height: int, mask_width: int) -> Dict[str, Any]:
    """label_data key order (reference 2056-2064)."""
    return {
        "frame_id": int(frame_id),
        "camera_pose": [float(v) for v in camera_pose7],
        "camera_params": camera_params,
        "objects": objects,
        "instance_mask_shape": [int(mask_height), int(mask_width)],
        "num_objects": len(objects),
        "class_mapping": dict(taxonomy.CONSTRUCTION_CLASS),
    }


def save_label_json(label: Dict[str, Any], filename: str) -> None:
    """Exact reference writer (608-613)."""
    with open(filename, "w", encoding="utf-8") as f:
        json.dump(label, f, indent=2, ensure_ascii=False)


def frame_objects(roster, inst_visible: np.ndarray, center: np.ndarray,
                  size: np.ndarray, euler_deg: np.ndarray) -> List[Dict[str, Any]]:
    """Visible-instance label list. inst_idx is assigned by order of
    appearance among visible objects, mirroring the reference's aggregation
    dict insertion order (1880-1891)."""
    out = []
    inst_idx = 0
    for o in range(roster.num_instances):
        if not inst_visible[o]:
            continue
        out.append(object_entry(
            inst_idx,
            int(roster.inst_class_id[o]),
            roster.inst_class_names[o],
            center[o], size[o], euler_deg[o],
            roster.inst_prim_paths[o],
        ))
        inst_idx += 1
    return out
