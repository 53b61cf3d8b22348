"""Convert the JAX package's state into the port's, through numpy.

The "weights" of the slices: one sampled scene, camera and light, one
``FrameBatch``, one flax parameter tree, or one training state (flax
parameters with optax ``adamw``'s moments), handed to both packages.
Inputs are anything ``np.asarray`` accepts (numpy or JAX arrays), read by
attribute or key, so this module imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from torch import nn

from .models import backbone
from .parallel.pipeline import FrameBatch
from .render.shading import Lighting
from .scene.world import ScenePose

ROSTER_ARRAYS = ("inst_class_id", "inst_aabb_min", "inst_aabb_max", "inst_albedo",
                 "inst_kpts", "inst_kpt_valid", "inst_kpt_channel", "inst_occlusion_group",
                 "prim_kind", "prim_offset", "prim_rot", "prim_params", "prim_inst")
ROSTER_STATIC = ("inst_prim_paths", "inst_class_names", "crane_slice", "dumper_slice",
                 "human_slice", "cone_slice", "tree_slice", "fence_slice")


def _t(x, device, batched: bool) -> torch.Tensor:
    a = np.array(x, np.float32)  # a writable copy
    return torch.as_tensor(a if batched else a[None], device=device)


def scene_pose(pose, device="cpu", batched: bool = True) -> ScenePose:
    """A JAX ``ScenePose`` (fields crane_pos, crane_yaw_deg, crane_joints,
    positions, yaw_deg, human_joints) -> the port's. ``batched=False``
    adds the leading batch dim of one frame."""
    hj = pose.human_joints
    return ScenePose(
        crane_pos=_t(pose.crane_pos, device, batched),
        crane_yaw_deg=_t(pose.crane_yaw_deg, device, batched),
        crane_joints=_t(pose.crane_joints, device, batched),
        positions=_t(pose.positions, device, batched),
        yaw_deg=_t(pose.yaw_deg, device, batched),
        human_joints=None if hj is None else _t(hj, device, batched),
    )


def cameras(cam_pos, target, device="cpu"):
    """(B, 3) camera positions and look-at targets -> tensors."""
    return _t(cam_pos, device, True), _t(target, device, True)


def lighting(lit, device="cpu", batched: bool = True) -> Lighting:
    """A JAX ``Lighting`` (scalar fields per frame) -> the port's."""
    return Lighting(*(_t(getattr(lit, f), device, batched) for f in Lighting._fields))


def roster_arrays(roster) -> Dict[str, object]:
    """A roster's tables as numpy, plus its static fields, for equality."""
    out = {k: np.asarray(getattr(roster, k)) for k in ROSTER_ARRAYS}
    out.update({k: getattr(roster, k) for k in ROSTER_STATIC})
    return out


def frame_batch(batch, device="cpu") -> FrameBatch:
    """A JAX ``FrameBatch`` -> the port's, with the same dtypes."""
    return FrameBatch(*(torch.as_tensor(np.array(getattr(batch, f)), device=device)
                        for f in FrameBatch._fields))


def _flax_paths(model: backbone._Backbone) -> Dict[str, tuple]:
    """{the port's layer name: its path in the flax parameter tree}, in
    the flax modules' order of creation (Conv_i, GroupNorm_i, ... per
    scope)."""
    out = {"stem": ("Conv_0",), "stem_norm": ("GroupNorm_0",)}
    for i, blk in enumerate(model.blocks):
        scope = f"ResBlock_{i}"
        for j, (conv, norm) in enumerate((("conv1", "norm1"), ("conv2", "norm2"))):
            out[f"blocks.{i}.{conv}"] = (scope, f"Conv_{j}")
            out[f"blocks.{i}.{norm}"] = (scope, f"GroupNorm_{j}")
        if blk.proj is not None:
            out[f"blocks.{i}.proj"] = (scope, "Conv_2")
            out[f"blocks.{i}.proj_norm"] = (scope, "GroupNorm_2")
    n_conv = 1
    for d in range(len(model.deconvs)):
        out[f"deconvs.{d}"] = (f"ConvTranspose_{d}",)
        if getattr(model, "use_skips", False):
            out[f"laterals.{d}"] = (f"Conv_{n_conv}",)
            n_conv += 1
        out[f"dec_norms.{d}"] = (f"GroupNorm_{d + 1}",)
    out["head"] = (f"Conv_{n_conv}",)
    return out


def pose_net_params(flax_params, model: backbone._Backbone) -> Dict[str, torch.Tensor]:
    """A flax ``HeatmapBackbone`` / ``LiteBackbone`` parameter tree (with or
    without its ``"params"`` level) -> the port model's ``state_dict``.

    Conv kernels go from HWIO to OIHW. Transposed-conv kernels go from
    (kh, kw, in, out) to (in, out, kh, kw) and are flipped spatially: flax's
    ``ConvTranspose`` (no kernel transpose) is a correlation of the dilated
    input, PyTorch's the adjoint of a convolution. GroupNorm scale and bias
    and the head's kernel and bias carry over."""
    tree = flax_params.get("params", flax_params)
    modules = dict(model.named_modules())
    sd = {}
    for name, path in _flax_paths(model).items():
        node = tree
        for key in path:
            node = node[key]
        m = modules[name]
        if isinstance(m, nn.GroupNorm):
            sd[f"{name}.weight"] = np.asarray(node["scale"])
            sd[f"{name}.bias"] = np.asarray(node["bias"])
            continue
        k = np.asarray(node["kernel"])
        if isinstance(m, nn.ConvTranspose2d):
            sd[f"{name}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            sd[f"{name}.weight"] = k.transpose(3, 2, 0, 1)
        if m.bias is not None:
            sd[f"{name}.bias"] = np.asarray(node["bias"])
    want = model.state_dict()
    if set(sd) != set(want):
        raise ValueError(f"flax tree does not match the model: {sorted(set(sd) ^ set(want))}")
    return {k: torch.as_tensor(np.array(v, np.float32), device=want[k].device)
            for k, v in sd.items()}


def train_state(state, model: backbone._Backbone, cfg):
    """A JAX ``TrainState`` (flax ``params``; ``opt_state`` the optax
    ``adamw`` chain (ScaleByAdamState(count, mu, nu), EmptyState,
    ScaleByScheduleState(count)); ``step``) -> the port's ``TrainState`` on
    ``model``, which takes the parameters. AdamW's moments and update count
    come from ``mu``, ``nu`` and ``count`` (converted like the parameters),
    the schedule's position from the schedule state's count."""
    from .train import loop

    adam, _, sched_state = state.opt_state
    model.load_state_dict(pose_net_params(state.params, model))
    opt, sched = loop.make_optimizer(cfg, model.parameters())
    mu, nu = pose_net_params(adam.mu, model), pose_net_params(adam.nu, model)
    count = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        opt.state[p] = {  # fused AdamW keeps its count on the card
            "step": torch.tensor(count, device=p.device if p.is_cuda else "cpu"),
            "exp_avg": torch.empty_like(p).copy_(mu[name]),
            "exp_avg_sq": torch.empty_like(p).copy_(nu[name])}
    sched.last_epoch = int(np.asarray(sched_state.count))
    for g in opt.param_groups:
        g["lr"] = sched.lr_lambdas[0](sched.last_epoch)
    return loop.TrainState(model.train(), opt, sched, int(np.asarray(state.step)))
