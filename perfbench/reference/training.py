"""The plain reference of a training cell: the first steps of the stage-1
job in float32 with TF32 off, from the weights the harness draws from the
seed and the batches the reference's own datagen makes again from the seed.

Each step generates its frames (the frozen plain pipeline, camera mix
included), draws their augment, preprocesses, runs the configuration's
model (its file's plain ``reference`` copy) in float32 (no autocast), takes
the focal loss, backpropagates and makes one AdamW update written out by
its formula (decoupled decay, bias corrections, eps outside the square
root) at optax's warmup-cosine learning rate for the update's count.

A cell of several cards trains its whole global batch here in one
process: the frames are generated in chunks of one rank's rows, as the
ranks generate them, the focal loss is normalised by the positives of the
whole batch, as the port's data-parallel step normalises it, and the
gradient is accumulated over the chunks before the one update.

``control=True`` runs every convolution and linear layer of the model in
fp8 as fp8 training does, but those its file names as its ``HEAD``: e4m3
inputs and weights forward, e5m2 gradients of its output backward, one
scale a tensor: the precision below the body's bfloat16 that the
configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.utils.parametrize as parametrize

from harness import configure, manifest
from reference.plain import config as ref_config
from reference.plain.ops import preprocess
from reference.plain.parallel import pipeline as ref_pipeline
from reference.plain.train import losses

BETAS, EPS = (0.9, 0.999), 1e-8
FP8_MAX = 448.0
E5M2_MAX = 57344.0
# The change after the steps counts only leaves whose first gradient is at
# least this share of the median leaf's.
MOVED = 1e-3


def lr_at(count: int, peak: float, warmup: int, steps: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup, max(steps,
    warmup + 1))`` at update ``count``."""
    decay = max(steps, warmup + 1) - warmup
    if count < warmup:
        return peak * max(count, 0) / warmup
    c = min(count - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale a tensor; the gradient passes."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x.detach())


class _FP8(torch.nn.Module):
    def forward(self, w):
        return fp8(w)


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2 with one scale a
    tensor, as fp8 training passes gradients back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = g.abs().amax().clamp_min(1e-30) / E5M2_MAX
        return (g / s).to(torch.float8_e5m2).to(g.dtype) * s


def quantize_body(model: torch.nn.Module, head=()) -> None:
    """Every convolution and linear layer but the modules ``head`` in fp8:
    e4m3 inputs and weights forward, e5m2 gradients of its output
    backward."""
    layers = (torch.nn.modules.conv._ConvNd, torch.nn.Linear)
    for name, m in model.named_modules():
        if isinstance(m, layers) and name not in head:
            parametrize.register_parametrization(m, "weight", _FP8())
            m.register_forward_pre_hook(lambda mod, args: (fp8(args[0]),) + args[1:])
            m.register_forward_hook(lambda mod, args, out: _GradE5M2.apply(out))


def leaf(name: str) -> str:
    """A parameter's name without parametrize's wrapping."""
    return name.replace("parametrizations.", "").replace(".original", "")


def steps(cell, seed: int, step_ids: list, device, control: bool = False,
          fault: str | None = None) -> dict:
    """The reference's steps ``step_ids`` (a list of frame-id lists): its
    batches' rgb and heatmaps, each step's loss, each leaf's first gradient,
    the leaves that count (``moved``) and their change over the steps.

    ``fault`` plants one of the faults a training step can have, for
    reading what it does to the compared numbers: ``"half"`` takes the loss
    over the first half of each batch, ``"altered"`` alters the first
    frame's RGB and heatmaps where they are produced."""
    mix = cell.mix
    cfg = configure.make_config(ref_config, cell.config, mix)
    pc, tc = cfg.pipeline, cfg.train
    if tc.loss != "focal":
        raise ValueError("the reference trains with the focal loss only")
    pipe = ref_pipeline.Pipeline(cfg, device=device, **cell.config["tier"])
    gen = pipe.make_generate_fn(ladder=False, camera_mix=tc.camera_mix or None)
    model = configure.build_model(cell, "reference", pipe.num_channels, seed, device).train()
    if control:
        quantize_body(model, getattr(manifest.model(cell.config["model"]["backbone"]), "HEAD", ()))
    params = [(leaf(n), p) for n, p in model.named_parameters()]
    start = {n: p.detach().clone() for n, p in params}
    state = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params}
    out = {"rgb": [], "heatmaps": [], "loss": [], "grads": {}}
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for i, ids in enumerate(step_ids):
            rows = len(ids) // cell.chips  # one rank's rows
            with torch.no_grad():
                parts = [gen(seed, ids[a:a + rows]) for a in range(0, len(ids), rows)]
                rgb = torch.cat([b.rgb for b in parts])
                heatmaps = torch.cat([b.heatmaps for b in parts])
                del parts
                if fault == "altered":
                    rgb[0] = 255 - rgb[0]
                    heatmaps[0] = 1.0 - heatmaps[0]
            out["rgb"].append(rgb)
            out["heatmaps"].append(heatmaps)
            used = len(ids) // 2 if fault == "half" else len(ids)
            n_pos = torch.sum(heatmaps[:used] > 0.9, dtype=torch.float32)
            model.zero_grad(set_to_none=True)
            total = 0.0
            for a in range(0, used, rows):
                b = min(a + rows, used)
                with torch.no_grad():
                    draws = preprocess.augment_draws(seed, ids[a:b], pc.render_height,
                                                     pc.render_width, device)
                images = preprocess.preprocess_frame(rgb[a:b], pc.render_height,
                                                     pc.render_width, augment=True, draws=draws)
                pred = model(images.permute(0, 3, 1, 2)).contiguous()
                loss = losses.focal_heatmap_loss(pred, heatmaps[a:b], n_pos=n_pos)
                loss.backward()
                total += float(loss.detach())
                del pred, loss, images, draws
            out["loss"].append(total)
            if i == 0:
                out["grads"] = {n: p.grad.detach().clone() for n, p in params}
                norms = {n: float(torch.linalg.vector_norm(g)) for n, g in out["grads"].items()}
                med = sorted(norms.values())[len(norms) // 2]
                # leaves whose gradient is nought to rounding (a bias under a
                # normalisation) move under Adam by round-off alone
                out["moved"] = {n for n, v in norms.items() if v >= MOVED * med}
            lr = lr_at(i, tc.learning_rate, tc.warmup_steps, tc.steps)
            with torch.no_grad():
                for n, p in params:
                    m, v = state[n]
                    g = p.grad
                    p.mul_(1.0 - lr * tc.weight_decay)
                    m.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                    v.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                    bc1, bc2 = 1.0 - BETAS[0] ** (i + 1), 1.0 - BETAS[1] ** (i + 1)
                    denom = (v.sqrt() / math.sqrt(bc2)).add_(EPS)
                    p.addcdiv_(m, denom, value=-lr / bc1)
        out["change"] = {n: p.detach() - start[n] for n, p in params}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out
