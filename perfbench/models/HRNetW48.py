"""The port's HRNet-W48 (arXiv:1902.09212; the official ``pose_hrnet.py``
layout): a two-convolution stem, a Bottleneck stage, then 1, 4 and 3
high-resolution modules over 2, 3 and 4 branches (48/96/192/384 channels
at strides 4/8/16/32) that exchange after every module, BatchNorm with
batch statistics throughout, a 1x1 head at stride 4; bfloat16 body and
float32 head. ``port`` builds it through the port's ``pose_net.make_model``;
``reference`` builds the plain float32 copy
(``reference/plain/models/hrnet.py``); ``weights`` draws both alike.

The head starts at the published scale. Drawn by the harness's fan-in rule,
it makes logits of std ~6.5 from the last fuse's sum, where the focal loss
is saturated and the first step's loss and gradient turn on a few pixels,
so that an RGB level's noise moves them as much as the fp8 control does. At
the official ``final_layer``'s N(0, 0.001) the logits start near 0, as in
the published recipe. Every other convolution is followed by BatchNorm,
which takes out its scale, so the body keeps the harness's draw."""

from __future__ import annotations

import inspect
import math

import torch

# the modules that the control leaves at the head's dtype
HEAD = ("head",)
# the official final_layer's std (pose_hrnet.py's init_weights)
HEAD_STD = 0.001
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
WIDTHS = ("width", "stage_modules", "blocks", "stem_features")
NORM = ("bn_momentum", "bn_eps", "output_stride")
KEYS = {"backbone", "body_dtype", "head_dtype", *WIDTHS, *NORM}


def _same(a, b) -> bool:
    seq = (list, tuple)
    return list(a) == list(b) if isinstance(a, seq) and isinstance(b, seq) else a == b


def _refuse(model_cfg: dict, built: dict) -> None:
    unknown = sorted(set(model_cfg) - KEYS)
    if unknown:
        raise ValueError(f"HRNetW48: make_model has no key {unknown[0]!r}")
    for key, value in built.items():
        if not _same(model_cfg[key], value):
            raise ValueError(f"HRNetW48: the model is built with {key}={value!r}, the "
                             f"configuration states {model_cfg[key]!r}")


def port(model_cfg: dict, num_channels: int, device) -> torch.nn.Module:
    """``pose_net.make_model(backbone="hrnet_w48")`` at the configuration's
    body dtype; raises, naming the key, where the configuration states what
    ``make_model`` does not build."""
    from constructionsceneposeestimation_tpu_torch.models import hrnet, pose_net

    defaults = inspect.signature(hrnet.HRNet).parameters
    _refuse(model_cfg, {**{k: defaults[k].default for k in WIDTHS},
                        "bn_momentum": hrnet.BN_MOMENTUM, "bn_eps": hrnet.BN_EPS,
                        "output_stride": hrnet.HRNet.output_stride})
    if model_cfg["head_dtype"] != "float32" or model_cfg["body_dtype"] not in DTYPES:
        raise ValueError("HRNetW48: make_model builds a float32 head and a bfloat16 "
                         "or float32 body (head_dtype, body_dtype)")
    return pose_net.make_model(num_channels, device=device, backbone="hrnet_w48",
                               dtype=DTYPES[model_cfg["body_dtype"]])


def reference(model_cfg: dict, num_channels: int, device) -> torch.nn.Module:
    """The plain copy at the configuration's widths, all in float32."""
    from reference.plain.models import hrnet

    mc = model_cfg
    _refuse({k: mc[k] for k in NORM}, {"bn_momentum": hrnet.MOMENTUM, "bn_eps": hrnet.EPS,
                                      "output_stride": hrnet.HRNet.output_stride})
    return hrnet.HRNet(num_channels, width=mc["width"], stage_modules=mc["stage_modules"],
                       blocks=mc["blocks"], stem_features=mc["stem_features"]).to(device)


def weights(model: torch.nn.Module, seed: int, device) -> None:
    """``configure.draw_weights`` from ``seed``, then the head's drawn
    weights scaled from std sqrt(1 / fan_in) to the published ``HEAD_STD``
    (a normal clipped at two std, as every drawn weight is)."""
    from harness import configure

    configure.draw_weights(model, seed, device)
    head = model.head
    with torch.no_grad():
        head.weight.mul_(HEAD_STD * math.sqrt(head.in_channels * math.prod(head.kernel_size)))
