"""Cells of training steps: ``train/loop.make_train_step(cfg, model, pipe)``
with the state of ``create_train_state``, each step generating its frames
inline (``frame ids i * B .. (i + 1) * B - 1``, the run's seed), then the
augment, forward, loss, backward and AdamW update. The model is the one the
configuration names, built from its file (``models/<backbone>.py``).

Set-up builds that one step and state, with weights the harness draws from
the seed, and drives it through its first ``check_steps`` steps by the
window's own call; those steps' batches, losses, the first gradient as the
optimizer holds it and the parameters' change are kept. The same object
then runs the window. After the window the reference follows the same
first steps and the two are compared.

A cell of several cards runs one rank a card (``ranks``): every rank builds
the port's ``make_sharded_train_step`` and places its state in DDP, and
generates and trains its rows of each global batch. Rank 0 times the window
and tells the others before each step whether it goes on; the check's
batches are every rank's rows gathered to rank 0, its first gradient and
change rank 0's, which DDP has averaged.
"""

from __future__ import annotations

import gc
import importlib
import sys

import torch

from . import compare, configure, ranks, tracing, window as win
from .manifest import Cell
from .session import SetupClock

PACKAGE = "constructionsceneposeestimation_tpu_torch"
# Limits on a group of ranks' life: its set-up, whose first run compiles,
# and then what follows the window.
SETUP_LIMIT_S = 1100.0
AFTER_WINDOW_S = 300.0
JOIN_S = 120.0


def model_flops_per_image(cell: Cell, num_channels: int, device) -> int:
    """FLOPs of one forward and backward of the configuration's model (the
    reference's copy, in float32) on one frame, by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    w, h = cell.config["resolution"]
    model = configure.build_model(cell, "reference", num_channels, None, device)
    x = torch.zeros(1, 3, h, w, device=device)
    counter = FlopCounterMode(display=False)
    with counter:
        model(x).sum().backward()
    return int(counter.get_total_flops())


class Trainer:
    """The port's training step and state on ``device``, weights drawn
    from ``seed``, and the frame ids that run on from step to step;
    ``sharded``, this rank's part of the data-parallel step."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, pipe=None,
                 sharded: bool = False):
        from constructionsceneposeestimation_tpu_torch import config as port_config
        from constructionsceneposeestimation_tpu_torch.parallel import pipeline as port_pipeline
        from constructionsceneposeestimation_tpu_torch.train import loop

        self.seed, self.B = seed, cell.mix["batch"]
        cfg = configure.make_config(port_config, cell.config, cell.mix)
        self.pipe = pipe or port_pipeline.Pipeline(cfg, device=device, **cell.config["tier"])
        self.model = configure.build_model(cell, "port", self.pipe.num_channels, seed, device)
        self.state = loop.create_train_state(cfg, self.model)
        if sharded:
            self.step, _, place = loop.make_sharded_train_step(cfg, self.model, self.pipe)
            self.state = place(self.state)
        else:
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

    def check_steps(self, n: int, group=ranks.Solo()) -> dict:
        """Run the first ``n`` steps by the window's own call, the step's
        generate wrapped to keep each batch; returns the batches (every
        rank's rows, gathered on rank 0), each step's frame ids and loss,
        the first gradient and the change."""
        kept = {"rgb": [], "heatmaps": [], "ids": []}
        gen = self.step.generate

        def keep(s, ids):
            batch, draws = gen(s, ids)
            kept["rgb"].append(batch.rgb)
            kept["heatmaps"].append(batch.heatmaps)
            return batch, draws

        self.step.generate = keep
        start = {k: p.detach().float().clone() for k, p in self.model.named_parameters()}
        loss = []
        try:
            for k in range(n):
                kept["ids"].append(list(range(self.next * self.B, (self.next + 1) * self.B)))
                loss.append(self.one()["loss"])
                if k == 0:
                    kept["grads"] = self.first_gradient()
        finally:
            del self.step.generate
        kept["loss"] = [float(x) for x in loss]
        kept["change"] = {k: p.detach().float() - start[k]
                          for k, p in self.model.named_parameters()}
        for field in ("rgb", "heatmaps"):
            kept[field] = [group.gather(x) for x in kept[field]]
        return kept


def train_numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared on a training cell's first steps: ``prog`` the
    program's (``Trainer.check_steps``), ``ref`` the reference's; the
    program's batches are compared on the reference's device."""
    hm_r, rgb_r = torch.cat(ref["heatmaps"]), torch.cat(ref["rgb"])
    hm_p = torch.cat(prog["heatmaps"]).to(hm_r.device)
    rgb_p = torch.cat(prog["rgb"]).to(rgb_r.device)
    return {
        "batch_rgb_frame_gap": float(compare.rgb_gaps(rgb_p, rgb_r).max()),
        "batch_heatmap_gap": compare._finite_gap(hm_p, hm_r),
        "loss_gap": max(abs(p - r) / max(abs(r), 1e-30)
                        for p, r in zip(prog["loss"], ref["loss"])),
        "grad_gap": compare.leaf_gap(prog["grads"], ref["grads"]),
        "grad_diff": compare.whole_diff(prog["grads"], ref["grads"]),
        "change_gap": compare.leaf_gap(prog["change"], ref["change"], keep=ref["moved"]),
    }


def _go(group, t: Trainer) -> None:
    group.tell(True)
    t.one()


def _steps(group, cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
           clock: SetupClock, held_ranks=None):
    """Set-up, window and profiled steps on one rank; rank 0's (metrics,
    extra, kept), None on the others."""
    mix, card, lead = cell.mix, device.type == "cuda", group.rank == 0
    B = mix["batch"]
    if card:
        torch.cuda.init()
        torch.zeros(1, device=device)
        clock.mark("cuda_context")
        importlib.import_module(f"{PACKAGE}.utils.kernels").library()
        clock.mark("kernel_load")
    t = Trainer(cell, seed, device, sharded=group.world > 1)
    clock.mark("tables_and_model")
    kept = t.check_steps(mix["check_steps"], group)
    clock.mark("check_steps")
    for _ in range(mix["warmup_batches"]):
        t.one()
    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    group.barrier()
    clock.mark("warmup")
    setup_s = clock.total()
    if held_ranks is not None:
        held_ranks.limit(seconds + AFTER_WINDOW_S)

    if lead:
        spans = tracing.Spans().install() if trace else None
        ends = win.run(win.Window(device), seconds, lambda i: _go(group, t))
        group.tell(False)
        n = len(ends)
    else:
        n = group.follow(t.one)
    peak = group.max(torch.cuda.max_memory_allocated(device) if card else 0)
    if trace and lead:
        with tracing.profiled(device) as held:
            for _ in range(mix["profile_batches"]):
                with torch.profiler.record_function(tracing.BATCH):
                    t.one()
        spans.remove()
    elif trace:
        for _ in range(mix["profile_batches"]):
            t.one()
    if card:
        torch.cuda.synchronize(device)
    group.barrier()
    if not lead:
        return None

    if trace:
        rows = B // group.world
        flops = model_flops_per_image(cell, t.pipe.num_channels, device) * rows
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
    extra.update(memory_peak_bytes=peak, batches=n)
    return metrics, extra, kept


def _follow(group, cell: Cell, seed: int, seconds: float, trace: bool, plant) -> None:
    """Ranks 1 to n-1 of a several-card cell."""
    clock = SetupClock(label=f"setup rank {group.rank}")
    clock.mark("import_and_join")
    with ranks.planted(plant):
        _steps(group, cell, seed, seconds, trace, group.device, clock)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        clock: SetupClock, plant=None):
    """One run of a training cell: rank 0's (metrics, extra, numbers).
    ``plant`` is entered around every rank's part (``ranks.planted``)."""
    clock.mark("import")
    with ranks.planted(plant):
        if cell.chips == 1:
            metrics, extra, kept = _steps(ranks.Solo(), cell, seed, seconds, trace, device, clock)
        else:
            with ranks.Ranks(cell.chips, device.type, _follow,
                             (cell, seed, seconds, trace, plant), SETUP_LIMIT_S) as held:
                group = held.group()
                clock.mark("ranks_joined")
                metrics, extra, kept = _steps(group, cell, seed, seconds, trace, device, clock,
                                              held)
                # every rank leaves the process group at once: NCCL's
                # teardown waits for the others
                group.close()
                held.join(JOIN_S)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from reference import training as ref_training

    numbers = train_numbers(kept, ref_training.steps(cell, seed, kept["ids"], device))
    return metrics, extra, numbers
