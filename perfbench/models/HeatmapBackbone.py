"""The port's ``HeatmapBackbone``: a Simple-Baselines ResNet (stem, four
stages of residual blocks with GroupNorm, three stride-2 transposed
convolutions with 1x1 laterals, a 1x1 head), bfloat16 body and float32
head. ``port`` builds it through the port's ``pose_net.make_model``;
``reference`` builds the frozen plain copy in float32."""

from __future__ import annotations

import inspect

import torch

# the modules that the control leaves at the head's dtype
HEAD = ("head",)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# widths that make_model leaves at HeatmapBackbone's defaults
WIDTHS = ("stage_features", "blocks_per_stage", "deconv_features", "use_skips")
KEYS = {"backbone", "output_stride", "body_dtype", "head_dtype", *WIDTHS}


def _same(a, b) -> bool:
    seq = (list, tuple)
    return list(a) == list(b) if isinstance(a, seq) and isinstance(b, seq) else a == b


def port(model_cfg: dict, num_channels: int, device) -> torch.nn.Module:
    """``pose_net.make_model`` at the configuration's stride and body dtype;
    raises, naming the key, where the configuration states what
    ``make_model`` does not build."""
    from constructionsceneposeestimation_tpu_torch.models import backbone, pose_net

    unknown = sorted(set(model_cfg) - KEYS)
    if unknown:
        raise ValueError(f"HeatmapBackbone: make_model has no key {unknown[0]!r}")
    defaults = inspect.signature(backbone.HeatmapBackbone).parameters
    for key in WIDTHS:
        if not _same(model_cfg[key], defaults[key].default):
            raise ValueError(f"HeatmapBackbone: make_model builds {key}="
                             f"{defaults[key].default!r}, the configuration states "
                             f"{model_cfg[key]!r}")
    if model_cfg["head_dtype"] != "float32" or model_cfg["body_dtype"] not in DTYPES:
        raise ValueError("HeatmapBackbone: make_model builds a float32 head and a bfloat16 "
                         "or float32 body (head_dtype, body_dtype)")
    return pose_net.make_model(num_channels, output_stride=model_cfg["output_stride"],
                               device=device, dtype=DTYPES[model_cfg["body_dtype"]])


def reference(model_cfg: dict, num_channels: int, device) -> torch.nn.Module:
    """The plain copy at the configuration's widths, all in float32."""
    from reference.plain.models import backbone

    mc = model_cfg
    return backbone.HeatmapBackbone(
        num_channels, stage_features=mc["stage_features"],
        blocks_per_stage=mc["blocks_per_stage"], deconv_features=mc["deconv_features"],
        output_stride=mc["output_stride"], use_skips=mc["use_skips"],
        dtype=torch.float32).to(device)
