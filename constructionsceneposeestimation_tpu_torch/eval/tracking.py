"""Host-side multi-object tracking and pose smoothing for the deployment
loop (``cli infer --track``). A copy of the JAX package's
``eval/tracking.py``: its code is the same text.

Greedy same-class IoU association from frame to frame, coasting through
short misses, and an exponential-moving-average smoother on accepted 6DoF
poses in the WORLD frame (the camera moves between frames, so smoothing in
the camera frame would blur real motion into apparent motion). Each
detection gains a ``track_id`` and, when its pose is accepted, smoothed
``R_world`` / ``t_world`` fields. Pure numpy: it post-processes the host
records. Quaternions follow the reference's Shepperd branch structure
(generate_construction_data.py:475-504), the labels' convention.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


# ---------------- small numpy pose algebra ----------------

def quat_from_matrix_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), Shepperd-style branch on
    the trace (reference rotMtx2quaternion semantics, returned in xyzw order
    to match the label schema's camera_pose quaternion)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def matrix_from_quat_np(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def world_pose_np(camera_pose7, R_cam, t_cam):
    """Camera-frame (R, t) -> world frame via the frame's [x y z qx qy qz qw]
    world-from-pinhole camera pose (same transform the labels use)."""
    R_wp = matrix_from_quat_np(np.asarray(camera_pose7[3:]))
    t_w = R_wp @ np.asarray(t_cam, np.float64) + np.asarray(camera_pose7[:3])
    R_w = R_wp @ np.asarray(R_cam, np.float64) if R_cam is not None else None
    return R_w, t_w


def _nlerp(q_prev: np.ndarray, q_new: np.ndarray, keep: float) -> np.ndarray:
    """EMA on quaternions: normalized lerp with hemisphere alignment —
    exact enough for the small inter-frame deltas EMA is meant to damp."""
    if np.dot(q_prev, q_new) < 0:
        q_new = -q_new
    q = keep * q_prev + (1.0 - keep) * q_new
    return q / np.linalg.norm(q)


def _iou(a, b) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    area = lambda x: max(0.0, x[2] - x[0]) * max(0.0, x[3] - x[1])
    u = area(a) + area(b) - inter
    return inter / u if u > 0 else 0.0


# ---------------- the tracker ----------------

class Tracker:
    """Greedy same-class IoU tracker with EMA pose smoothing.

    ``smooth`` is the EMA keep-fraction a: pose_s(t) = a * pose_s(t-1) +
    (1-a) * pose(t) (a=0 disables smoothing, identity pass-through of world
    poses). Tracks coast (stay matchable on their last box) for up to
    ``max_misses`` frames. Call :meth:`reset` at clip boundaries.
    """

    def __init__(self, min_iou: float = 0.1, max_misses: int = 3,
                 smooth: float = 0.5):
        self.min_iou = min_iou
        self.max_misses = max_misses
        self.smooth = float(smooth)
        self.reset()

    def reset(self) -> None:
        self._tracks: List[dict] = []
        self._next_id = 0

    @property
    def n_tracks_created(self) -> int:
        return self._next_id

    def _new_track(self, cls: str) -> dict:
        tr = {"id": self._next_id, "class": cls, "bbox": None,
              "q": None, "t": None, "misses": 0}
        self._next_id += 1
        self._tracks.append(tr)
        return tr

    def update(self, dets: List[dict],
               camera_pose7: Optional[List[float]] = None) -> List[dict]:
        """Annotate this frame's detections (mutated in place and returned).

        Each det dict needs ``class`` and ``bbox2d``; dets carrying an
        accepted camera-frame pose (``pose_accepted`` + ``R_cam``/``t_cam``)
        get world-frame EMA-smoothed ``R_world``/``t_world`` (requires
        ``camera_pose7``). Crane records (articulated, ``parts``) are matched
        on the union of part boxes and every part pose is smoothed."""
        # Prune dead tracks (misses exceeded): keeps per-frame cost and
        # memory proportional to ACTIVE tracks on long unreset streams.
        self._tracks = [tr for tr in self._tracks
                        if tr["misses"] <= self.max_misses]
        live = self._tracks
        used = set()
        pairs = []  # (det, track) by descending IoU, one-to-one
        cand = []
        for d in dets:
            box = _det_box(d)
            for tr in live:
                if tr["class"] != d["class"] or tr["bbox"] is None:
                    continue
                v = _iou(box, tr["bbox"])
                if v >= self.min_iou:
                    cand.append((v, id(d), d, tr))
        for v, _, d, tr in sorted(cand, key=lambda x: -x[0]):
            if id(d) in used or tr["id"] in {t["id"] for _, t in pairs}:
                continue
            used.add(id(d))
            pairs.append((d, tr))
        matched_ids = {t["id"] for _, t in pairs}
        for tr in self._tracks:
            if tr["id"] not in matched_ids:
                tr["misses"] += 1
        for d in dets:
            if id(d) not in used:
                pairs.append((d, self._new_track(d["class"])))
        for d, tr in pairs:
            tr["misses"] = 0
            tr["bbox"] = _det_box(d)
            d["track_id"] = tr["id"]
            self._smooth_pose(d, tr, camera_pose7)
        return dets

    # ---- pose smoothing ----

    def _smooth_pose(self, d: dict, tr: dict, camera_pose7) -> None:
        if camera_pose7 is None or not d.get("pose_accepted"):
            return
        if "parts" in d:  # articulated crane record: smooth per part
            qs, ts = tr.get("q"), tr.get("t")
            qs = qs if qs is not None else [None] * len(d["parts"])
            ts = ts if ts is not None else [None] * len(d["parts"])
            for i, part in enumerate(d["parts"]):
                if part.get("t_cam") is None:
                    continue
                R_w, t_w = world_pose_np(camera_pose7, part.get("R_cam"),
                                         part["t_cam"])
                qs[i], ts[i] = self._ema(qs[i], ts[i], R_w, t_w)
                part["R_world"] = matrix_from_quat_np(qs[i]).tolist()
                part["t_world"] = ts[i].tolist()
            tr["q"], tr["t"] = qs, ts
            return
        if d.get("t_cam") is None:
            return
        R_w, t_w = world_pose_np(camera_pose7, d.get("R_cam"), d["t_cam"])
        tr["q"], tr["t"] = self._ema(tr.get("q"), tr.get("t"), R_w, t_w)
        if tr["q"] is not None:
            d["R_world"] = matrix_from_quat_np(tr["q"]).tolist()
        d["t_world"] = tr["t"].tolist()

    def _ema(self, q_prev, t_prev, R_new, t_new):
        q_new = quat_from_matrix_np(R_new) if R_new is not None else None
        if t_prev is None:
            return q_new, np.asarray(t_new, np.float64)
        a = self.smooth
        t_s = a * np.asarray(t_prev) + (1.0 - a) * np.asarray(t_new)
        q_s = (_nlerp(np.asarray(q_prev), q_new, a)
               if q_prev is not None and q_new is not None else q_new)
        return q_s, t_s


def _det_box(d: dict) -> List[float]:
    """Matching box of a detection: its own bbox2d, or the union of the
    crane parts' boxes for articulated records."""
    if "bbox2d" in d:
        return d["bbox2d"]
    boxes = np.asarray([p["bbox2d"] for p in d["parts"]], np.float64)
    return [float(boxes[:, 0].min()), float(boxes[:, 1].min()),
            float(boxes[:, 2].max()), float(boxes[:, 3].max())]
