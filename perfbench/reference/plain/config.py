"""Framework configuration.

Dataclass configs exposing every knob of the reference generator's
module-constant blocks (generate_construction_data.py:31-65, 778-versus,
914-1231) plus the TPU-pipeline knobs that replace its simulator loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera knobs (reference: generate_construction_data.py:44-57, 1434-1446)."""

    width: int = 1280
    height: int = 720
    focal_length: float = 12.0  # wide FOV setting (reference: 1442)
    horizontal_aperture: float = 25.0  # reference: 1443
    clipping: Tuple[float, float] = (0.5, 250.0)  # reference: 1437
    distance_range: Tuple[float, float] = (15.0, 30.0)  # reference: 51
    height_range: Tuple[float, float] = (2.0, 6.0)  # reference: 52
    angle_range: Tuple[float, float] = (0.0, 360.0)  # reference: 53
    prim_path: str = "/World/Camera_0"  # reference: 45


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Data-quality gates (reference: generate_construction_data.py:58-61)."""

    min_pointcloud_points: int = 100
    max_retry_per_frame: int = 5
    enable_pointcloud_validation: bool = False


@dataclasses.dataclass(frozen=True)
class RandomizationConfig:
    """Object-placement randomization (reference: generate_construction_data.py:
    914-1231) and cadence (1542)."""

    cadence_frames: int = 10
    fence_x: Tuple[float, float] = (-9.0, 8.5)  # reference: 935
    fence_y: Tuple[float, float] = (-9.0, 9.0)  # reference: 936
    fence_margin: float = 0.5  # default margin in find_valid_position (958)
    cone_fence_margin: float = 1.0  # reference: 1211
    max_attempts: int = 80  # reference: 958
    crane_min_radius: float = 6.0  # reference: 1092
    crane_range: float = 4.0  # +-4 m about the center (reference: 1097)
    dumper_min_radius: float = 2.5  # reference: 1126
    dumper_range: float = 2.0  # reference: 1134
    human_radius: float = 0.8  # reference: 1162
    human_range: float = 4.0  # reference: 1170
    cone_radius: float = 0.5  # reference: 1204
    cone_center_range: float = 6.0  # reference: 1209
    cone_range: float = 2.0  # reference: 1211
    # 7 candidate dumper areas (reference: 1110-1118)
    dumper_areas: Tuple[Tuple[float, float], ...] = (
        (-7.0, -1.0),
        (-3.0, -5.0),
        (5.0, 0.0),
        (-5.0, 5.0),
        (3.0, -4.0),
        (6.0, 3.0),
        (-6.0, -4.0),
    )


@dataclasses.dataclass(frozen=True)
class LightingConfig:
    """Lighting model parameters (reference setup_scene_lighting,
    generate_construction_data.py:1289-1345), extended with DR jitter ranges."""

    dome_intensity: float = 500.0
    dome_color: Tuple[float, float, float] = (0.75, 0.85, 1.0)
    dome_specular: float = 0.5
    distant_intensity_cap: float = 1500.0
    # Domain-randomization jitter (TPU build extension):
    intensity_jitter: float = 0.3  # +-30% multiplicative
    sun_elevation_range: Tuple[float, float] = (20.0, 70.0)  # degrees
    sun_azimuth_range: Tuple[float, float] = (0.0, 360.0)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Scene roster — the world2.usd content as a static TPU scene table
    (asset inventory: SURVEY.md section 2.2)."""

    n_cones: int = 8
    n_trees: int = 6
    n_fence_panels: int = 20  # perimeter
    n_humans: int = 1
    n_dumpers: int = 1
    n_cranes: int = 1
    # Fence perimeter geometry: the reference crate's authored ring spans
    # x [-11.5, 10.1], y [-11.3, 10.0] (panel centers; ring center offset
    # ~-0.7 m — tools/calibrate_proxies.py). The repo centers its ring, so
    # the half-extent is the measured half-span.
    fence_half_x: float = 10.8
    fence_half_y: float = 10.7
    tree_ring_radius: float = 12.5  # trees sit outside the fence (reference: 933)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Batched datagen pipeline (replaces the reference main loop,
    generate_construction_data.py:1540-2081)."""

    max_iterations: int = 41  # reference: 64
    batch_size: int = 64  # frames per device step (TPU build)
    render_width: int = 512  # north-star resolution (BASELINE.json)
    render_height: int = 512
    heatmap_stride: int = 4
    heatmap_sigma: float = 2.0  # in heatmap pixels
    seed: int = 0
    bug_compatible_schema: bool = False  # byte-parity quirks (camera quat)
    write_rgb: bool = True
    write_depth: bool = True
    write_pointcloud: bool = True
    write_labels: bool = True
    write_instance_mask: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Heatmap-regression training (BASELINE.json config 5)."""

    batch_size: int = 32
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    steps: int = 10000
    warmup_steps: int = 500
    bf16: bool = True
    loss: str = "mse"  # "mse" | "focal"
    camera_mix: float = 0.0  # P(close-range ladder view) per train frame;
    # 0 = pure DR sampler. Mixing fixes range domain shift (ROADMAP round 2).
    channel_balance: bool = True  # de-emphasize crowded classes (20 fences
    # share channels; the dumper has one instance) by 1/sqrt(instances)
    # mesh axes: (data, model); fsdp shards params over 'data'
    mesh_shape: Tuple[int, ...] = (8,)
    mesh_axes: Tuple[str, ...] = ("data",)
    fsdp: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    camera: CameraConfig = CameraConfig()
    quality: QualityConfig = QualityConfig()
    randomization: RandomizationConfig = RandomizationConfig()
    lighting: LightingConfig = LightingConfig()
    scene: SceneConfig = SceneConfig()
    pipeline: PipelineConfig = PipelineConfig()
    train: TrainConfig = TrainConfig()
    output_dir: str = "dataset_construction_world2_v3"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

