"""Batch -> disk orchestration (the reference's per-frame save calls, batched
and taken off the critical path with a thread pool).

Writes the exact reference dataset tree:

  dataset_<task>/rgb/rgb_%06d.png
                 depth/depth_%06d.{csv,png}
                 pointcloud/pointcloud_%06d.txt
                 labels/{label_%06d.json, instance_mask_%06d.npy}
                 logs/{generation_detail.log, generation_summary.json,
                       manifest.json}

A port of the JAX package's ``io/dataset_writer.py`` that writes the same
bytes. It takes a host batch: a ``FrameBatch`` of numpy arrays
(``parallel/pipeline.HostCopy`` copies one off the card) or of CPU
tensors. Pointcloud text is derived host-side, in numpy, from depth+rgb
with the same backprojection the labels promise (camera_pose applied to
pinhole rays), so files stay mutually consistent and its ``%.6f`` text
is the JAX writer's.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Optional

import numpy as np

from ..config import Config
from ..core import camera as cam_mod
from . import quality, resume, schema, writers


def _np_backproject_xyzrgb(depth: np.ndarray, rgb: np.ndarray,
                           fx: float, fy: float, cx: float, cy: float,
                           pose7: np.ndarray) -> np.ndarray:
    """Valid-masked (N, 6) xyzrgb via the reference fallback math
    (generate_construction_data.py:616-711) — correct with our camera_pose."""
    h, w = depth.shape
    valid = np.isfinite(depth) & (depth > 0) & (depth < 250.0)
    if not valid.any():
        return np.zeros((0, 6), np.float32)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z = depth[valid]
    x = (u[valid] - cx) * z / fx
    y = (v[valid] - cy) * z / fy
    pin = np.stack([x, y, z], -1)
    qx, qy, qz, qw = pose7[3:]
    # quaternion -> rotation matrix (xyzw)
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ], np.float32)
    world = pin @ R.T + pose7[:3]
    colors = rgb[valid].astype(np.float32)
    return np.concatenate([world, colors], -1).astype(np.float32)


class DatasetWriter:
    def __init__(self, cfg: Config, root: Optional[str] = None,
                 max_workers: int = 8, echo_log: bool = False):
        self.cfg = cfg
        self.dirs = writers.ensure_dataset_dirs(root or cfg.output_dir)
        self.logger = quality.DataQualityLogger(self.dirs["logs"], echo=echo_log)
        self.pool = cf.ThreadPoolExecutor(max_workers=max_workers)
        # Dedicated 1-worker executor for manifest finalization: each batch's
        # record_completed must run only AFTER that batch's file writes have
        # all resolved (a crash mid-batch must not mark unwritten frames
        # complete — they'd be skipped forever on resume). A separate executor
        # keeps the waiter from starving the write pool, and its single worker
        # serializes manifest updates.
        self.manifest_pool = cf.ThreadPoolExecutor(max_workers=1)
        self.pending: list = []
        self._batch_futs: list = []
        pc = cfg.pipeline
        self.cam_params = schema.camera_params_dict(
            cfg.camera.focal_length, cfg.camera.horizontal_aperture,
            pc.render_width, pc.render_height,
        )
        intr = cam_mod.intrinsics_from_apertures(
            cfg.camera.focal_length, cfg.camera.horizontal_aperture,
            pc.render_width, pc.render_height,
        )
        self.fx, self.fy = float(intr.fx), float(intr.fy)
        self.cx, self.cy = float(intr.cx), float(intr.cy)

    def _submit(self, fn, *args):
        fut = self.pool.submit(fn, *args)
        self.pending.append(fut)
        self._batch_futs.append(fut)

    def write_batch(self, batch, roster) -> None:
        """FrameBatch (numpy arrays or CPU tensors) -> files + quality log."""
        self._batch_futs = []
        cfg = self.cfg.pipeline
        frame_ids = np.asarray(batch.frame_id)
        rgb = np.asarray(batch.rgb)
        depth = np.asarray(batch.depth)
        instance = np.asarray(batch.instance)
        pose7 = np.asarray(batch.camera_pose7)
        visible = np.asarray(batch.inst_visible)
        center = np.asarray(batch.center)
        size = np.asarray(batch.size)
        euler = np.asarray(batch.euler_deg)
        pc_count = np.asarray(batch.pointcloud_count)

        for b, fid in enumerate(frame_ids):
            fid = int(fid)
            self.logger.log_frame_start(fid, pose7[b, :3])
            n_pts = int(pc_count[b])
            self.logger.log_pointcloud(n_pts > 0, n_pts,
                                       "" if n_pts > 0 else "无有效深度像素")
            if cfg.write_rgb:
                self._submit(writers.save_rgb_png,
                             os.path.join(self.dirs["rgb"], f"rgb_{fid:06d}.png"), rgb[b])
                self.logger.log_rgb(True)
            if cfg.write_depth:
                d = depth[b]
                self.logger.log_depth(True, d)
                self._submit(writers.save_depth_csv,
                             os.path.join(self.dirs["depth"], f"depth_{fid:06d}.csv"), d)
                self._submit(writers.save_depth_png,
                             os.path.join(self.dirs["depth"], f"depth_{fid:06d}.png"), d)
            if cfg.write_pointcloud:
                self._submit(self._write_pointcloud, fid, depth[b], rgb[b], pose7[b])
            objects = schema.frame_objects(roster, visible[b], center[b], size[b], euler[b])
            if cfg.write_labels:
                label = schema.label_dict(fid, pose7[b], self.cam_params, objects,
                                          cfg.render_height, cfg.render_width)
                self._submit(schema.save_label_json, label,
                             os.path.join(self.dirs["labels"], f"label_{fid:06d}.json"))
            if cfg.write_instance_mask:
                self._submit(writers.save_instance_mask,
                             os.path.join(self.dirs["labels"], f"instance_mask_{fid:06d}.npy"),
                             instance[b], cfg.render_height, cfg.render_width,
                             self.cfg.pipeline.bug_compatible_schema)
            self.logger.log_labels(len(objects))
            self.logger.log_frame_end(True)

        def _finalize(futs=self._batch_futs, ids=[int(f) for f in frame_ids]):
            for f in futs:
                f.result()  # raises on any failed write: batch stays pending
            resume.record_completed(self.dirs["root"], ids)

        self.pending.append(self.manifest_pool.submit(_finalize))

    def _write_pointcloud(self, fid: int, depth, rgb, pose7) -> None:
        xyzrgb = _np_backproject_xyzrgb(depth, rgb, self.fx, self.fy,
                                        self.cx, self.cy, pose7)
        writers.save_pointcloud(
            os.path.join(self.dirs["pointcloud"], f"pointcloud_{fid:06d}.txt"), xyzrgb)

    def flush(self) -> None:
        for fut in self.pending:
            fut.result()
        self.pending.clear()

    def finish(self) -> str:
        self.flush()
        report = self.logger.save_summary()
        self.pool.shutdown(wait=True)
        self.manifest_pool.shutdown(wait=True)
        return report
