"""Cells of training steps: ``train/loop.make_train_step(cfg, model, pipe)``
with the state of ``create_train_state``, each step generating its frames
inline (``frame ids i * B .. (i + 1) * B - 1``, the run's seed), then the
augment, forward, loss, backward and AdamW update.

Set-up builds that one step and state, with weights the harness draws from
the seed, and drives it through its first ``check_steps`` steps by the
window's own call; those steps' batches, losses, the first gradient as the
optimizer holds it and the parameters' change are kept. The same object
then runs the window. After the window the reference follows the same
first steps and the two are compared.
"""

from __future__ import annotations

import importlib
import sys

import torch

from . import compare, configure, tracing, window as win
from .manifest import Cell
from .session import SetupClock

PACKAGE = "constructionsceneposeestimation_tpu_torch"


def model_flops_per_image(cell: Cell, num_channels: int, device) -> int:
    """FLOPs of one forward and backward of the configuration's backbone (the
    reference's copy, in float32) on one frame, by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from reference.plain.models import backbone

    mc, (w, h) = cell.config["model"], cell.config["resolution"]
    model = backbone.HeatmapBackbone(
        num_channels, stage_features=mc["stage_features"],
        blocks_per_stage=mc["blocks_per_stage"], deconv_features=mc["deconv_features"],
        output_stride=mc["output_stride"], use_skips=mc["use_skips"],
        dtype=torch.float32).to(device)
    x = torch.zeros(1, 3, h, w, device=device)
    counter = FlopCounterMode(display=False)
    with counter:
        model(x).sum().backward()
    return int(counter.get_total_flops())


class Trainer:
    """The port's training step and state on ``device``, weights drawn
    from ``seed``, and the frame ids that run on from step to step."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, pipe=None):
        from constructionsceneposeestimation_tpu_torch import config as port_config
        from constructionsceneposeestimation_tpu_torch.models import pose_net
        from constructionsceneposeestimation_tpu_torch.parallel import pipeline as port_pipeline
        from constructionsceneposeestimation_tpu_torch.train import loop

        if cell.config["model"]["backbone"] != "HeatmapBackbone":
            raise ValueError("a training cell runs the port's HeatmapBackbone")
        self.seed, self.B = seed, cell.mix["batch"]
        cfg = configure.make_config(port_config, cell.config, cell.mix)
        self.pipe = pipe or port_pipeline.Pipeline(cfg, device=device, **cell.config["tier"])
        self.model = pose_net.make_model(device=device)
        configure.draw_weights(self.model, seed, device)
        self.state = loop.create_train_state(cfg, self.model)
        self.step = loop.make_train_step(cfg, self.model, self.pipe)
        self.next = 0

    def one(self) -> dict:
        i, self.next = self.next, self.next + 1
        self.state, metrics = self.step(self.state, self.seed,
                                        range(i * self.B, (i + 1) * self.B))
        return metrics

    def first_gradient(self) -> dict:
        """Each leaf's gradient of the first update as AdamW holds it: its
        first moment after one step over (1 - beta1); zero for a leaf the
        optimizer holds no state of (no update was made)."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        return {n: opt.state[p]["exp_avg"].detach().float().clone() / (1.0 - beta1)
                if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p, dtype=torch.float32)
                for n, p in self.model.named_parameters()}

    def check_steps(self, n: int) -> dict:
        """Run the first ``n`` steps by the window's own call, the step's
        generate wrapped to keep each batch; returns the batches, the frame
        ids, each step's loss, the first gradient and the change."""
        kept = {"rgb": [], "heatmaps": [], "ids": []}
        gen = self.step.generate

        def keep(s, ids):
            batch, draws = gen(s, ids)
            kept["rgb"].append(batch.rgb)
            kept["heatmaps"].append(batch.heatmaps)
            kept["ids"].append(list(ids))
            return batch, draws

        self.step.generate = keep
        start = {k: p.detach().float().clone() for k, p in self.model.named_parameters()}
        loss = []
        try:
            for k in range(n):
                loss.append(self.one()["loss"])
                if k == 0:
                    kept["grads"] = self.first_gradient()
        finally:
            del self.step.generate
        kept["loss"] = [float(x) for x in loss]
        kept["change"] = {k: p.detach().float() - start[k]
                          for k, p in self.model.named_parameters()}
        return kept


def train_numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared on a training cell's first steps: ``prog`` the
    program's (``Trainer.check_steps``), ``ref`` the reference's."""
    hm_p, hm_r = torch.cat(prog["heatmaps"]), torch.cat(ref["heatmaps"])
    return {
        "batch_rgb_frame_gap": float(compare.rgb_gaps(torch.cat(prog["rgb"]),
                                                      torch.cat(ref["rgb"])).max()),
        "batch_heatmap_gap": compare._finite_gap(hm_p, hm_r),
        "loss_gap": max(abs(p - r) / max(abs(r), 1e-30)
                        for p, r in zip(prog["loss"], ref["loss"])),
        "grad_gap": compare.leaf_gap(prog["grads"], ref["grads"]),
        "grad_diff": compare.whole_diff(prog["grads"], ref["grads"]),
        "change_gap": compare.leaf_gap(prog["change"], ref["change"], keep=ref["moved"]),
    }


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        clock: SetupClock):
    mix, card = cell.mix, device.type == "cuda"
    B = mix["batch"]
    clock.mark("import")
    if card:
        torch.cuda.init()
        torch.zeros(1, device=device)
        clock.mark("cuda_context")
        importlib.import_module(f"{PACKAGE}.utils.kernels").library()
        clock.mark("kernel_load")
    t = Trainer(cell, seed, device)
    clock.mark("tables_and_model")
    kept = t.check_steps(mix["check_steps"])
    clock.mark("check_steps")
    for _ in range(mix["warmup_batches"]):
        t.one()
    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    clock.mark("warmup")
    setup_s = clock.total()

    spans = tracing.Spans().install() if trace else None
    ends = win.run(win.Window(device), seconds, lambda i: t.one())
    n = len(ends)
    peak = int(torch.cuda.max_memory_allocated(device)) if card else 0
    if trace:
        with tracing.profiled(device) as held:
            for _ in range(mix["profile_batches"]):
                with torch.profiler.record_function(tracing.BATCH):
                    t.one()
        spans.remove()
        flops = model_flops_per_image(cell, t.pipe.num_channels, device) * B
        tr = tracing.Trace(held.events, mix["profile_batches"], spans, n,
                           tracing.handwritten_kernels(),
                           {"model_flops_per_step": flops, "window_s": ends[-1] * 1e-3})
        metrics = {"trace": tr}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s, "breakdown": tr.breakdown()}
    else:
        metrics = {"train_img_per_s": n * B / (ends[-1] * 1e-3), "setup_s": setup_s}
        extra = {}
        gap = win.gaps(ends)
        print(f"[window] {n} steps of {B} frames in {ends[-1]:.1f} ms; step ms median "
              f"{win.percentile(gap, 50.0):.3f}, p95 {win.percentile(gap, 95.0):.3f}",
              file=sys.stderr)
    del t
    if card:
        torch.cuda.empty_cache()

    from reference import training as ref_training

    numbers = train_numbers(kept, ref_training.steps(cell, seed, kept["ids"], device))
    extra.update(memory_peak_bytes=peak, batches=n)
    return metrics, extra, numbers
