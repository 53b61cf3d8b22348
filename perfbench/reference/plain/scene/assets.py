"""Procedural CAD proxy assets + canonical keypoint sets.

The reference renders USD CAD models (crane Pk7.501, dumper 09684481, traffic
cones, Zeppelin fencing, trees, a DHGen rigged worker — asset inventory in
SURVEY.md section 2.2) through Isaac's RTX renderer. All of its *labels* are
geometry-derived, so the TPU build replaces those meshes with analytic
primitive proxies (planes/spheres/boxes/cylinders/cones/capsules) that a
batched ray-caster intersects in closed form — static shapes, no mesh I/O,
MXU/VPU-friendly.

Every class also carries a canonical keypoint set in object-local coordinates;
these drive the heatmap/PnP pipeline (BASELINE.json north star). Crane parts
use their box corners (actual surface corners of the box geometry), the dumper
uses semantic surface features (wheel hubs, cab/bed corners — see its
docstring), and the human uses the 17-keypoint COCO skeleton (config 3).

Dimensions are in meters at world2.usd scale (fence height 2 m per the asset
filename `Construction_Site...Fencing-height-2`; crane boom reach ~6-8 m per
generate_construction_data.py:924, 1089-1092; dumper radius ~2.5-3 m per 1125).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# Primitive kinds understood by render/raycast.py
PLANE = 0  # params: unused (z=0 plane in local frame)
SPHERE = 1  # params: (radius, -, -, -)
BOX = 2  # params: (hx, hy, hz, -) half-extents
CYLINDER = 3  # params: (radius, half_height, -, -) axis = local +Z
CONE = 4  # params: (r_bottom, r_top, half_height, -) axis = local +Z, truncated
CAPSULE = 5  # params: (radius, half_height, -, -) segment on local +Z

KIND_NAMES = {PLANE: "plane", SPHERE: "sphere", BOX: "box", CYLINDER: "cylinder",
              CONE: "cone", CAPSULE: "capsule"}


@dataclasses.dataclass(frozen=True)
class ClassTemplate:
    """Static per-class proxy geometry, all numpy (host-side constants)."""

    name: str
    class_id: int
    prim_kind: np.ndarray  # (P,) int32
    prim_offset: np.ndarray  # (P, 3) local positions
    prim_rot: np.ndarray  # (P, 3, 3) local rotations
    prim_params: np.ndarray  # (P, 4)
    keypoints: np.ndarray  # (K, 3) local
    kpt_names: Tuple[str, ...]
    aabb_min: np.ndarray  # (3,) local AABB
    aabb_max: np.ndarray  # (3,)
    albedo: np.ndarray  # (3,) base color for the shaded RGB render

    @property
    def num_prims(self) -> int:
        return int(self.prim_kind.shape[0])

    @property
    def num_keypoints(self) -> int:
        return int(self.keypoints.shape[0])


def _aabb_corner_keypoints(amin, amax) -> Tuple[np.ndarray, Tuple[str, ...]]:
    amin = np.asarray(amin, np.float32)
    amax = np.asarray(amax, np.float32)
    pts = []
    names = []
    for iz, z in enumerate((amin[2], amax[2])):
        for iy, y in enumerate((amin[1], amax[1])):
            for ix, x in enumerate((amin[0], amax[0])):
                pts.append([x, y, z])
                names.append(f"corner_{'x+' if ix else 'x-'}{'y+' if iy else 'y-'}{'z+' if iz else 'z-'}")
    return np.asarray(pts, np.float32), tuple(names)


def _template(name, class_id, prims, keypoints, kpt_names, aabb, albedo) -> ClassTemplate:
    kinds = np.asarray([p[0] for p in prims], np.int32)
    offsets = np.asarray([p[1] for p in prims], np.float32)
    rots = np.stack([np.asarray(p[2], np.float32) if p[2] is not None else np.eye(3, dtype=np.float32)
                     for p in prims])
    params = np.asarray([list(p[3]) + [0.0] * (4 - len(p[3])) for p in prims], np.float32)
    return ClassTemplate(
        name=name,
        class_id=class_id,
        prim_kind=kinds,
        prim_offset=offsets,
        prim_rot=rots,
        prim_params=params,
        keypoints=np.asarray(keypoints, np.float32),
        kpt_names=tuple(kpt_names),
        aabb_min=np.asarray(aabb[0], np.float32),
        aabb_max=np.asarray(aabb[1], np.float32),
        albedo=np.asarray(albedo, np.float32),
    )


def trafficcone_template() -> ClassTemplate:
    # Calibrated against the reference scene crate (tools/calibrate_proxies.py
    # on cad_models/world2.usd.backup): measured 0.519 x 0.519 footprint,
    # 0.686 m tall (was an estimated 0.40 x 0.40 x 0.70).
    kpts = np.array(
        [
            [0.0, 0.0, 0.69],  # apex
            [0.0, 0.0, 0.0],  # base_center
            [0.26, 0.0, 0.0],
            [-0.26, 0.0, 0.0],
            [0.0, 0.26, 0.0],
            [0.0, -0.26, 0.0],
        ],
        np.float32,
    )
    names = ("apex", "base_center", "base_px", "base_nx", "base_py", "base_ny")
    prims = [
        (CONE, [0.0, 0.0, 0.37], None, [0.20, 0.03, 0.32]),  # z in [0.05, 0.69]
        (BOX, [0.0, 0.0, 0.025], None, [0.26, 0.26, 0.025]),
    ]
    return _template("trafficcone", 0, prims, kpts, names,
                     ([-0.26, -0.26, 0.0], [0.26, 0.26, 0.69]), [1.0, 0.35, 0.05])


def tree_template() -> ClassTemplate:
    # Calibrated against the reference scene crate (tools/calibrate_proxies.py
    # on cad_models/world2.usd.backup): all 12 tree instances are one asset,
    # 4.24 x 4.99 x 7.59 m total — trunk+branches mesh 3.1 x 3.7 x 7.2,
    # foliage 4.2 x 5.0 x 7.1 reaching nearly to the ground. Proxy: tall
    # trunk cylinder + two stacked canopy spheres approximating the leafy
    # volume (was an estimated 2.4 x 2.4 x 4.0).
    kpts = np.array(
        [
            [0.0, 0.0, 0.0],  # root
            [0.0, 0.0, 2.9],  # trunk_top
            [0.0, 0.0, 5.0],  # canopy_center
            [0.0, 0.0, 7.5],  # canopy_top
        ],
        np.float32,
    )
    names = ("root", "trunk_top", "canopy_center", "canopy_top")
    prims = [
        (CYLINDER, [0.0, 0.0, 1.6], None, [0.20, 1.6]),
        # Two stacked spheres, not one capsule: spheres ride the cheapest
        # transform-elided sweep category (a capsule tree measured 6% slower
        # end-to-end despite one fewer prim).
        (SPHERE, [0.0, 0.0, 3.6], None, [2.1]),
        (SPHERE, [0.0, 0.0, 5.6], None, [2.2]),
    ]
    return _template("tree", 1, prims, kpts, names,
                     ([-2.3, -2.3, 0.0], [2.3, 2.3, 7.6]), [0.15, 0.40, 0.10])


def fence_template() -> ClassTemplate:
    # One Zeppelin mobile fencing panel. Calibrated against the reference
    # scene crate (tools/calibrate_proxies.py on world2.usd.backup): measured
    # 3.731 m wide x 2.001 m high, 0.898 m deep at the transverse stabilizer
    # feet; panels stand at a 3.58 m pitch (slight frame overlap).
    hx, hz = 1.866, 1.0
    kpts = np.array(
        [
            [-hx, 0.0, 0.0],  # bottom_left
            [hx, 0.0, 0.0],  # bottom_right
            [-hx, 0.0, 2.0],  # top_left
            [hx, 0.0, 2.0],  # top_right
            [0.0, 0.0, 2.0],  # top_mid
            [0.0, 0.0, 0.0],  # bottom_mid
        ],
        np.float32,
    )
    names = ("bottom_left", "bottom_right", "top_left", "top_right", "top_mid", "bottom_mid")
    prims = [
        (BOX, [0.0, 0.0, 1.0], None, [hx, 0.02, hz]),
        # The edge posts (r=0.03 cylinders at x = +-hx, z 0..2) and the
        # stabilizer feet (0.9 m transverse, 0.14 m tall) are label-only:
        # the AABB below includes them (the reference's 3D boxes do). The
        # posts are geometrically coincident with the solid panel box — they
        # protrude 0.01 m past its faces and 0.03 m past its width, sub-pixel
        # beyond ~3 m — yet cost 40 of 116 sweep prims (2 per panel, 20
        # panels); the feet subtend < 5 px at DR range and cost 40 more.
        # Sweep prim count dominates datagen throughput, so
        # both live only in the AABB/keypoint tables.
    ]
    return _template("fence", 2, prims, kpts, names,
                     ([-1.90, -0.45, 0.0], [1.90, 0.45, 2.0]), [0.55, 0.55, 0.58])


def cranebase_template() -> ClassTemplate:
    # Axis keypoints, not corners: the base proxy box is 180-degree yaw
    # symmetric, so corner IDENTITIES are unlearnable from appearance —
    # measured median 24-48 crop-px error at score ~0.45 on two corners,
    # which passed the solve's score gate and dragged the FK pose meters
    # off. Axis points are symmetry-invariant; the base only needs to anchor
    # XY (yaw/pitch observability comes from boom/telescopic via the chain).
    aabb = ([-1.1, -0.5, 0.0], [1.1, 0.5, 0.5])
    kpts, names = _axis_keypoints([0, 0, 0], [0, 0, 0.5], 3, "base")
    prims = [(BOX, [0.0, 0.0, 0.25], None, [1.1, 0.5, 0.25])]
    return _template("cranebase", 6, prims, kpts, names, aabb, [0.85, 0.12, 0.10])


def _axis_keypoints(p0, p1, n: int, prefix: str):
    """``n`` evenly spaced points on the segment p0 -> p1 (part AXIS points).

    Articulated revolution-style parts (column, boom, telescopic) use axis
    points instead of box corners: a square-section column's four corners are
    interchangeable under its own yaw symmetry, so a heatmap net cannot learn
    their identities (measured crop-stage column ADD-0.1d 0.32 with corners).
    Axis points are symmetry-invariant, and the FK-constrained joint solve
    (ops/pnp.solve_crane_pose) needs no per-part yaw observability — column
    yaw comes from the boom direction through the kinematic chain."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    ts = np.linspace(0.0, 1.0, n, dtype=np.float32)
    pts = p0[None, :] + ts[:, None] * (p1 - p0)[None, :]
    names = tuple(f"{prefix}_axis_{i}" for i in range(n))
    return pts, names


def cranecolumn_template() -> ClassTemplate:
    aabb = ([-0.3, -0.3, 0.0], [0.3, 0.3, 1.5])
    kpts, names = _axis_keypoints([0, 0, 0], [0, 0, 1.5], 5, "col")
    prims = [(BOX, [0.0, 0.0, 0.75], None, [0.3, 0.3, 0.75])]
    return _template("cranecolumn", 7, prims, kpts, names, aabb, [0.85, 0.15, 0.10])


def craneboom_template() -> ClassTemplate:
    # Boom extends along local +X from its pivot at the origin. Axis points
    # plus TOP/BOTTOM surface points at root and tip: z-offset points carry no
    # symmetry ambiguity (up is unambiguous from the pitched pose/shading) and
    # restore solver conditioning that pure collinear axis points lose
    # (measured GT-floor ADD-0.1d 0.63 axis-only vs 0.95 with cross points).
    aabb = ([0.0, -0.15, -0.15], [4.0, 0.15, 0.15])
    ax, ax_names = _axis_keypoints([0, 0, 0], [4.0, 0, 0], 3, "boom")
    cross = np.array([[0.0, 0.0, 0.15], [0.0, 0.0, -0.15],
                      [4.0, 0.0, 0.15], [4.0, 0.0, -0.15]], np.float32)
    kpts = np.concatenate([ax, cross])
    names = ax_names + ("boom_root_top", "boom_root_bottom",
                        "boom_tip_top", "boom_tip_bottom")
    prims = [(BOX, [2.0, 0.0, 0.0], None, [2.0, 0.15, 0.15])]
    return _template("craneboom", 8, prims, kpts, names, aabb, [0.90, 0.18, 0.08])


def cranetelescopic_template() -> ClassTemplate:
    aabb = ([0.0, -0.10, -0.10], [3.0, 0.10, 0.10])
    ax, ax_names = _axis_keypoints([0, 0, 0], [3.0, 0, 0], 3, "tele")
    cross = np.array([[3.0, 0.0, 0.10], [3.0, 0.0, -0.10]], np.float32)
    kpts = np.concatenate([ax, cross])
    names = ax_names + ("tele_tip_top", "tele_tip_bottom")
    prims = [(BOX, [1.5, 0.0, 0.0], None, [1.5, 0.10, 0.10])]
    return _template("cranetelescopic", 9, prims, kpts, names, aabb, [0.95, 0.25, 0.05])


def crane_template() -> ClassTemplate:
    # Whole-crane aggregate: used only when part mapping is unavailable
    # (reference get_object_root fallback, generate_construction_data.py:216-217).
    aabb = ([-1.1, -0.5, 0.0], [7.0, 0.5, 2.0])
    kpts, names = _aabb_corner_keypoints(*aabb)
    return _template("crane", 3, [(BOX, [0.0, 0.0, 0.25], None, [1.1, 0.5, 0.25])],
                     kpts, names, aabb, [0.85, 0.12, 0.10])


def dumper_template() -> ClassTemplate:
    # Dump truck: chassis + cab (front, +X) + bed (rear).
    #
    # Keypoints are SEMANTIC surface features (wheel hubs, cab/bed corners),
    # not AABB corners: the union-shape AABB corners float in empty space
    # (e.g. wheel-height at chassis extent), which a heatmap net cannot
    # localize — measured 8-40 px corner errors vs <3 px for surface features.
    aabb = ([-2.25, -1.1, 0.0], [2.25, 1.1, 2.2])
    kpts = np.array(
        [
            [1.5, 1.1, 0.45],    # wheel_front_left (hub, outer face)
            [1.5, -1.1, 0.45],   # wheel_front_right
            [-1.5, 1.1, 0.45],   # wheel_rear_left
            [-1.5, -1.1, 0.45],  # wheel_rear_right
            [2.25, 1.05, 2.2],   # cab_top_front_left
            [2.25, -1.05, 2.2],  # cab_top_front_right
            [-2.1, 1.05, 1.9],   # bed_top_rear_left
            [-2.1, -1.05, 1.9],  # bed_top_rear_right
            [1.45, 0.0, 2.2],    # cab_top
            [-0.8, 0.0, 1.9],    # bed_center
        ],
        np.float32,
    )
    names = ("wheel_front_left", "wheel_front_right", "wheel_rear_left",
             "wheel_rear_right", "cab_top_front_left", "cab_top_front_right",
             "bed_top_rear_left", "bed_top_rear_right", "cab_top", "bed_center")
    prims = [
        (BOX, [0.0, 0.0, 0.9], None, [2.25, 1.1, 0.45]),  # chassis, z in [0.45, 1.35]
        (BOX, [1.45, 0.0, 1.75], None, [0.8, 1.05, 0.45]),  # cab
        (BOX, [-0.8, 0.0, 1.6], None, [1.3, 1.05, 0.3]),  # bed
        (CYLINDER, [1.5, 1.1, 0.45], np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32), [0.45, 0.15]),
        (CYLINDER, [1.5, -1.1, 0.45], np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32), [0.45, 0.15]),
        (CYLINDER, [-1.5, 1.1, 0.45], np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32), [0.45, 0.15]),
        (CYLINDER, [-1.5, -1.1, 0.45], np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32), [0.45, 0.15]),
    ]
    return _template("dumper", 4, prims, kpts, names, aabb, [0.95, 0.75, 0.10])


# 17-keypoint COCO skeleton, canonical standing pose (~1.75 m), facing +X.
COCO_KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)

# Local frame: +X facing direction, +Y = person's left, +Z up.
CANONICAL_COCO = np.array(
    [
        [0.08, 0.00, 1.66],  # nose
        [0.07, 0.03, 1.70],  # left_eye
        [0.07, -0.03, 1.70],  # right_eye
        [0.02, 0.07, 1.68],  # left_ear
        [0.02, -0.07, 1.68],  # right_ear
        [0.00, 0.20, 1.45],  # left_shoulder
        [0.00, -0.20, 1.45],  # right_shoulder
        [0.00, 0.24, 1.15],  # left_elbow
        [0.00, -0.24, 1.15],  # right_elbow
        [0.00, 0.26, 0.88],  # left_wrist
        [0.00, -0.26, 0.88],  # right_wrist
        [0.00, 0.11, 0.95],  # left_hip
        [0.00, -0.11, 0.95],  # right_hip
        [0.00, 0.12, 0.50],  # left_knee
        [0.00, -0.12, 0.50],  # right_knee
        [0.00, 0.13, 0.05],  # left_ankle
        [0.00, -0.13, 0.05],  # right_ankle
    ],
    np.float32,
)

# Capsule segments (joint_a, joint_b, radius) building the body volume; -1 is
# a virtual mid-shoulder/mid-hip anchor handled in kinematics.
HUMAN_SEGMENTS = (
    (5, 7, 0.055), (7, 9, 0.045),  # left arm
    (6, 8, 0.055), (8, 10, 0.045),  # right arm
    (11, 13, 0.08), (13, 15, 0.06),  # left leg
    (12, 14, 0.08), (14, 16, 0.06),  # right leg
)
HUMAN_TORSO_RADIUS = 0.16
HUMAN_HEAD_RADIUS = 0.11


def human_template() -> ClassTemplate:
    """Human proxy in the canonical pose. Runtime articulation re-derives the
    capsule transforms from posed joints (kinematics.human_prims)."""
    kpts = CANONICAL_COCO.copy()
    prims: List = []
    # Head
    head_center = CANONICAL_COCO[0] + np.array([-0.06, 0.0, 0.04], np.float32)
    prims.append((SPHERE, head_center.tolist(), None, [HUMAN_HEAD_RADIUS]))
    # Torso capsule between mid-shoulder and mid-hip
    mid_sh = (CANONICAL_COCO[5] + CANONICAL_COCO[6]) / 2
    mid_hip = (CANONICAL_COCO[11] + CANONICAL_COCO[12]) / 2
    prims.append(_capsule_between(mid_sh, mid_hip, HUMAN_TORSO_RADIUS))
    for a, b, r in HUMAN_SEGMENTS:
        prims.append(_capsule_between(CANONICAL_COCO[a], CANONICAL_COCO[b], r))
    return _template("human", 5, prims, kpts, COCO_KEYPOINT_NAMES,
                     ([-0.30, -0.30, 0.0], [0.30, 0.30, 1.80]), [0.95, 0.85, 0.10])


def _capsule_between(a, b, radius):
    """Capsule primitive (local +Z axis) between two points."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    center = (a + b) / 2
    d = b - a
    length = float(np.linalg.norm(d))
    z = d / max(length, 1e-6)
    # Build a rotation whose +Z is `z`.
    up = np.array([1.0, 0.0, 0.0]) if abs(z[2]) > 0.9 else np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    x = x / max(np.linalg.norm(x), 1e-6)
    y = np.cross(z, x)
    rot = np.stack([x, y, z], axis=1).astype(np.float32)
    return (CAPSULE, center.tolist(), rot, [radius, length / 2])


def ground_template() -> ClassTemplate:
    return _template("ground", -1, [(PLANE, [0.0, 0.0, 0.0], None, [0.0])],
                     np.zeros((0, 3), np.float32), (),
                     ([-25.0, -25.0, -0.1], [25.0, 25.0, 0.0]), [0.45, 0.40, 0.35])


def all_templates() -> Dict[str, ClassTemplate]:
    return {
        t.name: t
        for t in (
            trafficcone_template(),
            tree_template(),
            fence_template(),
            crane_template(),
            dumper_template(),
            human_template(),
            cranebase_template(),
            cranecolumn_template(),
            craneboom_template(),
            cranetelescopic_template(),
        )
    }


def keypoint_channel_table() -> Tuple[Dict[Tuple[str, int], int], int]:
    """Global heatmap channel layout: (class_name, kpt_idx) -> channel.

    Classes appear in class-id order (0..9); channels are contiguous per class.
    """
    templates = all_templates()
    by_id = sorted(templates.values(), key=lambda t: t.class_id)
    table: Dict[Tuple[str, int], int] = {}
    ch = 0
    for t in by_id:
        for k in range(t.num_keypoints):
            table[(t.name, k)] = ch
            ch += 1
    return table, ch


NUM_KEYPOINT_CHANNELS = keypoint_channel_table()[1]
MAX_KEYPOINTS_PER_OBJECT = max(t.num_keypoints for t in all_templates().values())
