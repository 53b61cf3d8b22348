"""A configuration file and a mix turned into the ``Config`` of the port or
of the reference (the two have the same dataclasses), and the model's
weights drawn from the seed."""

from __future__ import annotations

import math

import torch

GROUPS = ("camera", "randomization", "lighting", "scene")


def _tuples(d: dict) -> dict:
    conv = lambda v: tuple(conv(x) for x in v) if isinstance(v, list) else v
    return {k: conv(v) for k, v in d.items()}


def make_config(config_mod, config: dict, mix: dict):
    """``config_mod.Config`` as the configuration file states it, at the
    mix's batch (and, for a training mix, its optimizer and schedule)."""
    width, height = config["resolution"]
    groups = {g: getattr(config_mod, f"{g.capitalize()}Config")(**_tuples(config[g]))
              for g in GROUPS}
    pipeline = config_mod.PipelineConfig(render_width=width, render_height=height,
                                         batch_size=mix["batch"],
                                         **_tuples(config["pipeline"]))
    train = config_mod.TrainConfig()
    if mix["kind"] == "train":
        train = config_mod.TrainConfig(
            batch_size=mix["batch"], learning_rate=mix["learning_rate"],
            weight_decay=mix["weight_decay"], steps=mix["steps"],
            warmup_steps=mix["warmup_steps"], loss=mix["loss"], camera_mix=mix["camera_mix"],
            bf16=config["model"]["body_dtype"] == "bfloat16")
    return config_mod.Config(pipeline=pipeline, train=train, **groups)


@torch.no_grad()
def draw_weights(model: torch.nn.Module, seed: int, device) -> None:
    """Fill ``model``'s parameters from ``seed`` with a generator on
    ``device``, in one call: convolution kernels normal with std
    sqrt(1 / fan_in) (flax's LeCun scale), clipped at two std; biases 0;
    GroupNorm scales 1. The same seed gives the same weights to any model of
    the same parameter names and shapes."""
    params = [(n, p) for n, p in model.named_parameters()]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    total = sum(p.numel() for n, p in params if n.endswith("weight") and p.dim() == 4)
    noise = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    i = 0
    for name, p in params:
        if name.endswith("weight") and p.dim() == 4:
            transposed = isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                                    torch.nn.ConvTranspose2d)
            fan_in = p.shape[0 if transposed else 1] * p.shape[2] * p.shape[3]
            n = p.numel()
            p.copy_(noise[i:i + n].view(p.shape) * math.sqrt(1.0 / fan_in))
            i += n
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
