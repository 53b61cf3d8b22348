"""A configuration file and a mix turned into the ``Config`` of the port or
of the reference (the two have the same dataclasses), and the
configuration's model built from its file with weights drawn from the
seed."""

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


def _fan_in(model: torch.nn.Module, name: str, p: torch.Tensor) -> int:
    """The fan-in of parameter ``name`` of two or more dimensions, by the
    module that owns it: a convolution's input channels over its groups times
    its kernel (a transposed one's ``weight.shape[0]``, its input channels,
    over its groups), a ``Linear``'s input features."""
    owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and isinstance(owner, torch.nn.modules.conv._ConvTransposeNd):
        return p.shape[0] // owner.groups * math.prod(owner.kernel_size)
    if leaf == "weight" and isinstance(owner, torch.nn.modules.conv._ConvNd):
        return owner.in_channels // owner.groups * math.prod(owner.kernel_size)
    if leaf == "weight" and isinstance(owner, torch.nn.Linear):
        return owner.in_features
    raise ValueError(f"draw_weights: no rule for parameter {name!r} "
                     f"({type(owner).__name__}, shape {tuple(p.shape)})")


@torch.no_grad()
def draw_weights(model: torch.nn.Module, seed: int, device) -> None:
    """Fill ``model``'s parameters from ``seed`` with a generator on
    ``device``, in one call: every parameter of two or more dimensions, in
    parameter order, normal with std sqrt(1 / fan_in) of the module that owns
    it (flax's LeCun scale), clipped at two std; other weights (norm scales)
    1; biases 0. BatchNorm's running mean is set to 0, its running variance
    to 1 and its count of batches to 0. A parameter no rule covers raises,
    naming it. The same seed gives the same weights to any model of the same
    parameter names and shapes."""
    params = list(model.named_parameters())
    drawn = [(p, _fan_in(model, name, p)) for name, p in params if p.dim() >= 2]
    rest = [(name, name.rsplit(".", 1)[-1], p) for name, p in params if p.dim() < 2]
    for name, leaf, p in rest:
        if leaf not in ("weight", "bias"):
            raise ValueError(f"draw_weights: no rule for parameter {name!r} "
                             f"(shape {tuple(p.shape)})")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    noise = torch.randn(sum(p.numel() for p, _ in drawn), generator=g,
                        device=device).clamp_(-2.0, 2.0)
    i = 0
    for p, fan_in in drawn:
        n = p.numel()
        p.copy_(noise[i:i + n].view(p.shape) * math.sqrt(1.0 / fan_in))
        i += n
    for _, leaf, p in rest:
        if leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._NormBase) and m.track_running_stats:
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()


def build_model(cell, side: str, num_channels: int, seed: int | None, device) -> torch.nn.Module:
    """The configuration's model from its file (``manifest.model``):
    ``side`` "port" or "reference", with weights drawn from ``seed`` (by the
    file's ``weights`` where it has one), or as built where ``seed`` is
    None."""
    from .manifest import model as model_file

    mod = model_file(cell.config["model"]["backbone"])
    model = getattr(mod, side)(cell.config["model"], num_channels, device)
    if seed is not None:
        getattr(mod, "weights", draw_weights)(model, seed, device)
    return model
