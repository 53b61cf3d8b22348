"""Data-quality logging — schema-compatible with the reference's
DataQualityLogger (generate_construction_data.py:237-470).

Emits the same two sinks:
  logs/generation_detail.log   human-readable per-frame log (same line
                               format, including the reference's Chinese
                               status strings so downstream issue-histogram
                               parsing — split on ':' (458) — matches)
  logs/generation_summary.json {"statistics": {...}, "frame_logs": [...]}
                               with the exact statistics key set (244-254)

Here the per-frame facts arrive in batches of host copies instead of being
observed one retry at a time. A copy of the JAX package's ``io/quality.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


class DataQualityLogger:
    def __init__(self, log_dir: str, echo: bool = False):
        self.log_dir = log_dir
        self.echo = echo
        os.makedirs(log_dir, exist_ok=True)
        self.frame_logs: List[dict] = []
        self.statistics: Dict = {
            "total_frames_attempted": 0,
            "successful_frames": 0,
            "failed_frames": 0,
            "retry_count": 0,
            "pointcloud_stats": {"valid": 0, "empty": 0, "insufficient": 0},
            "rgb_stats": {"valid": 0, "failed": 0},
            "depth_stats": {"valid": 0, "failed": 0, "all_zero": 0, "all_inf": 0},
            "label_stats": {"valid": 0, "empty": 0},
            "object_count": {"total": 0, "per_frame_avg": 0},
        }
        from pathlib import Path

        timestamp = Path(log_dir).parent.name
        self.detail_log_path = os.path.join(log_dir, "generation_detail.log")
        self.summary_log_path = os.path.join(log_dir, "generation_summary.json")
        with open(self.detail_log_path, "w", encoding="utf-8") as f:
            f.write("=== 数据生成详细日志 ===\n")
            f.write(f"开始时间: {timestamp}\n\n")
        self.current_frame: dict = {}

    def _write_log(self, msg: str) -> None:
        with open(self.detail_log_path, "a", encoding="utf-8") as f:
            f.write(msg)
        if self.echo:
            print(msg, end="")

    # ---- per-frame API (reference method-for-method) ----
    def log_frame_start(self, frame_id: int, cam_pos) -> None:
        msg = f"\n{'=' * 60}\n帧 {frame_id} 开始采集\n相机位置: {cam_pos}\n"
        self._write_log(msg)
        self.current_frame = {
            "frame_id": frame_id,
            "camera_position": cam_pos.tolist() if hasattr(cam_pos, "tolist") else cam_pos,
            "retry_count": 0,
            "status": "processing",
            "issues": [],
        }

    def log_retry(self, retry_count: int) -> None:
        self.current_frame["retry_count"] = retry_count
        self.statistics["retry_count"] += 1
        self._write_log(f"  ⚠ 重试 {retry_count} 次\n")

    def log_pointcloud(self, valid: bool, point_count: int = 0, reason: str = "") -> None:
        if valid:
            self.statistics["pointcloud_stats"]["valid"] += 1
            self.current_frame["pointcloud"] = {"status": "valid", "points": point_count}
            msg = f"  ✓ 点云: {point_count} 个点\n"
        elif point_count == 0:
            self.statistics["pointcloud_stats"]["empty"] += 1
            self.current_frame["issues"].append(f"点云为空: {reason}")
            msg = f"  ✗ 点云为空: {reason}\n"
        else:
            self.statistics["pointcloud_stats"]["insufficient"] += 1
            self.current_frame["issues"].append(f"点云不足: {point_count} 点")
            msg = f"  ✗ 点云不足: {point_count} 点 ({reason})\n"
        self._write_log(msg)

    def log_rgb(self, valid: bool, reason: str = "") -> None:
        if valid:
            self.statistics["rgb_stats"]["valid"] += 1
            self.current_frame["rgb"] = {"status": "valid"}
            msg = "  ✓ RGB图像采集成功\n"
        else:
            self.statistics["rgb_stats"]["failed"] += 1
            self.current_frame["issues"].append(f"RGB失败: {reason}")
            msg = f"  ✗ RGB图像失败: {reason}\n"
        self._write_log(msg)

    def log_depth(self, valid: bool, depth_data: Optional[np.ndarray] = None,
                  reason: str = "") -> None:
        if valid and depth_data is not None:
            finite_pos = np.isfinite(depth_data) & (depth_data > 0)
            valid_pixels = int(np.sum(finite_pos))
            total_pixels = int(depth_data.size)
            zero_pixels = int(np.sum(depth_data == 0))
            inf_pixels = int(np.sum(np.isinf(depth_data)))
            vals = depth_data[finite_pos]
            if len(vals) > 0:
                dmin, dmax, dmean = float(vals.min()), float(vals.max()), float(vals.mean())
            else:
                dmin = dmax = dmean = 0.0
            self.current_frame["depth"] = {
                "status": "valid",
                "valid_pixels": valid_pixels,
                "total_pixels": total_pixels,
                "valid_ratio": float(valid_pixels / total_pixels),
                "zero_pixels": zero_pixels,
                "inf_pixels": inf_pixels,
                "depth_range": [dmin, dmax],
                "depth_mean": dmean,
            }
            if zero_pixels == total_pixels:
                self.statistics["depth_stats"]["all_zero"] += 1
                self.current_frame["issues"].append("深度图全为零")
                msg = "  ⚠ 深度图: 全为零值！\n"
            elif inf_pixels == total_pixels:
                self.statistics["depth_stats"]["all_inf"] += 1
                self.current_frame["issues"].append("深度图全为无穷")
                msg = "  ⚠ 深度图: 全为无穷值！\n"
            else:
                self.statistics["depth_stats"]["valid"] += 1
                msg = (f"  ✓ 深度图: 有效像素 {valid_pixels}/{total_pixels} "
                       f"({100 * valid_pixels / total_pixels:.1f}%)\n"
                       f"    深度范围: [{dmin:.2f}, {dmax:.2f}] 平均: {dmean:.2f}\n")
        else:
            self.statistics["depth_stats"]["failed"] += 1
            self.current_frame["issues"].append(f"深度图失败: {reason}")
            msg = f"  ✗ 深度图失败: {reason}\n"
        self._write_log(msg)

    def log_labels(self, object_count: int) -> None:
        if object_count > 0:
            self.statistics["label_stats"]["valid"] += 1
            self.statistics["object_count"]["total"] += object_count
            self.current_frame["labels"] = {"status": "valid", "object_count": object_count}
            msg = f"  ✓ 标签: {object_count} 个物体\n"
        else:
            self.statistics["label_stats"]["empty"] += 1
            self.current_frame["issues"].append("未识别到物体")
            msg = "  ⚠ 标签: 0 个物体（可能视野外或未匹配类别）\n"
        self._write_log(msg)

    def log_frame_end(self, success: bool) -> None:
        self.statistics["total_frames_attempted"] += 1
        if success:
            self.statistics["successful_frames"] += 1
            self.current_frame["status"] = "success"
            msg = f">>> 帧 {self.current_frame['frame_id']} 完成 ✓\n"
        else:
            self.statistics["failed_frames"] += 1
            self.current_frame["status"] = "failed"
            msg = f">>> 帧 {self.current_frame['frame_id']} 失败 ✗\n"
        self._write_log(msg)
        self.frame_logs.append(self.current_frame.copy())

    # ---- summary ----
    def save_summary(self) -> str:
        if self.statistics["successful_frames"] > 0:
            self.statistics["object_count"]["per_frame_avg"] = (
                self.statistics["object_count"]["total"]
                / self.statistics["successful_frames"]
            )
        self.statistics["success_rate"] = (
            self.statistics["successful_frames"]
            / max(1, self.statistics["total_frames_attempted"])
        )
        with open(self.summary_log_path, "w", encoding="utf-8") as f:
            json.dump({"statistics": self.statistics, "frame_logs": self.frame_logs},
                      f, indent=2, ensure_ascii=False)
        report = self._generate_report()
        with open(self.detail_log_path, "a", encoding="utf-8") as f:
            f.write(f"\n\n{'=' * 60}\n")
            f.write(report)
        return report

    def _generate_report(self) -> str:
        stats = self.statistics
        report = "=== 数据生成汇总报告 ===\n\n"
        report += "总体统计:\n"
        report += f"  尝试帧数: {stats['total_frames_attempted']}\n"
        report += f"  成功帧数: {stats['successful_frames']}\n"
        report += f"  失败帧数: {stats['failed_frames']}\n"
        report += f"  成功率: {stats['success_rate'] * 100:.1f}%\n"
        report += f"  总重试次数: {stats['retry_count']}\n\n"
        report += "点云质量:\n"
        report += f"  有效: {stats['pointcloud_stats']['valid']}\n"
        report += f"  为空: {stats['pointcloud_stats']['empty']}\n"
        report += f"  不足: {stats['pointcloud_stats']['insufficient']}\n\n"
        report += "RGB图像:\n"
        report += f"  成功: {stats['rgb_stats']['valid']}\n"
        report += f"  失败: {stats['rgb_stats']['failed']}\n\n"
        report += "深度图:\n"
        report += f"  有效: {stats['depth_stats']['valid']}\n"
        report += f"  失败: {stats['depth_stats']['failed']}\n"
        report += f"  全零: {stats['depth_stats']['all_zero']}\n"
        report += f"  全无穷: {stats['depth_stats']['all_inf']}\n\n"
        report += "标签识别:\n"
        report += f"  有效: {stats['label_stats']['valid']}\n"
        report += f"  为空: {stats['label_stats']['empty']}\n"
        report += f"  总物体数: {stats['object_count']['total']}\n"
        report += f"  平均每帧: {stats['object_count']['per_frame_avg']:.2f}\n\n"
        report += "常见问题:\n"
        issue_count: Dict[str, int] = {}
        for frame in self.frame_logs:
            for issue in frame.get("issues", []):
                issue_type = issue.split(":")[0]
                issue_count[issue_type] = issue_count.get(issue_type, 0) + 1
        for issue_type, count in sorted(issue_count.items(), key=lambda x: x[1], reverse=True):
            report += f"  {issue_type}: {count} 次\n"
        return report
