"""Heatmap-regression training with datagen in the loop (port of the JAX
``train/loop.py``).

A step generates its batch on the device (``Pipeline.make_generate_fn``,
under ``torch.no_grad()``: the rendered RGB and the targets are constants
of the loss), draws the frames' photometric augment, then runs
``train_on_batch``: preprocess with the augment, the backbone's forward
(bf16 body, f32 head), the loss, autograd's backward and one AdamW update.

The optimizer is optax's ``adamw`` on ``warmup_cosine_decay_schedule(0,
lr, warmup, max(steps, warmup + 1))``: ``torch.optim.AdamW`` with one
parameter group (every tensor decays, GroupNorm's too, as optax masks
none), eps 1e-8 outside the square root, and a ``LambdaLR`` whose factor
is the schedule's learning rate at the count of updates made before this
one. So the first update has lr 0 and changes no weight, while the Adam
moments advance. ``make_scanned_train_fn`` is a host loop of ``inner``
steps; a step's randomness depends only on (seed, frame id).
``make_data_train_step`` is the same step on batches read from packed
shards (``io/reader.ShardDataset``) instead of generated.

``make_sharded_train_step`` is the step over the ranks of a
``torch.distributed`` group (``parallel/mesh.py``): each rank generates and
augments its contiguous rows of the global batch, and the model is wrapped
in DDP, or sharded by FSDP2 when ``cfg.train.fsdp``. Its numbers are the
single-device step's on the global batch, as the JAX sharded ``jit``'s
are: the focal loss divides by the global count of positives (reduced
across the ranks, outside the gradient) and each rank's loss is scaled by
the world size, so the ranks' gradient mean is the global gradient; MSE's
per-rank means average to the global mean as they are, the shards being
equal. The ``loss`` metric is reduced, so every rank reports the global
loss.

Normalization: ``HeatmapBackbone`` and ``LiteBackbone`` use GroupNorm,
per sample, so there the sharded step's numbers are the global batch's.
HRNet (``models/hrnet.py``) uses BatchNorm: ``create_train_state`` puts
the model in train mode, where a batch is normalized by its own
statistics and the running ones are updated; evaluation (``.eval()``)
normalizes by the running ones. Under ``make_sharded_train_step`` each
rank normalizes its rows by their own statistics, as the published recipe
(``nn.BatchNorm2d`` under ``DataParallel``) does: no SyncBatchNorm, so the
step is the single-device step run on each rank's rows, the loss still
over the global positives. DDP keeps DDP's default ``broadcast_buffers``:
before each forward rank 0's running statistics are copied to every rank,
so the statistics that are kept are rank 0's, as ``DataParallel`` keeps
the one copy its first replica updates. FSDP2 broadcasts no buffer: each
rank keeps the running statistics of its own rows.

Spans (``utils/profiling.annotate``; free with no profiler active): a step
is ``train.step``, holding the generate's ``gen.batch``, the augment draws
(``train.augment``) and ``BatchStep``'s halves (``train.forward_backward``,
``train.update``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..config import Config, TrainConfig
from ..models import pose_net
from ..ops import preprocess
from ..parallel import mesh as mesh_mod
from ..parallel import pipeline as pipeline_mod
from ..scene import world as world_mod
from ..utils.profiling import annotate as span
from . import losses

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and schedule, and the updates made."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1))`` as a function of the update count: linear from 0 to lr
    over ``warmup_steps``, then a cosine to 0 at ``steps``."""
    peak, warm = tc.learning_rate, tc.warmup_steps
    decay = max(tc.steps, warm + 1) - warm

    def lr(count: int) -> float:
        if count < warm:
            return -peak * (1.0 - max(count, 0) / warm) + peak
        c = min(count - warm, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return lr


def make_optimizer(cfg: Config, params):
    """(AdamW, LambdaLR) over ``params``: optax ``adamw(schedule,
    weight_decay=cfg.train.weight_decay)``. The group's base lr is 1, so
    the scheduler's factor is the learning rate itself. Plain parameters on
    the card take the fused implementation; FSDP2's sharded parameters
    (DTensors) take the foreach one."""
    params = list(params)
    sharded = isinstance(params[0], DTensor)
    opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.train.weight_decay,
                            fused=params[0].is_cuda and not sharded, foreach=sharded or None)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule(cfg.train))


def create_train_state(cfg: Config, model: nn.Module) -> TrainState:
    """``model`` (initialized by ``pose_net.make_model(seed=...)``, as the
    JAX ``create_train_state`` initializes from its key) in train mode, with
    a fresh optimizer."""
    opt, sched = make_optimizer(cfg, model.train().parameters())
    return TrainState(model, opt, sched, 0)


def apply_update(state: TrainState) -> TrainState:
    """One AdamW update from the gradients left in the parameters, then the
    schedule's step."""
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state


def channel_weights_from_roster(roster) -> Tensor:
    """Per-channel loss weights: 1/sqrt(instances of the channel's class),
    normalized to mean 1, so crowded classes (fence x20) stop drowning out
    single-instance equipment channels."""
    ch = np.asarray(roster.inst_kpt_channel)
    counts = np.bincount(ch[ch >= 0], minlength=int(ch.max()) + 1).astype(np.float32)
    w = 1.0 / np.sqrt(np.maximum(counts, 1.0))
    return torch.as_tensor(w / w.mean())


class BatchStep:
    """``train_on_batch(state, batch, draws) -> (state, metrics)`` for one
    config: the loss of ``cfg.train.loss`` (the roster's channel weights
    apply to MSE only, as in the JAX step, where focal takes none), its
    gradients, then one update. The two halves are separate methods so
    that they can be timed apart."""

    def __init__(self, cfg: Config, roster):
        self.cfg = cfg
        self.ch_w = channel_weights_from_roster(roster) if cfg.train.channel_balance else None

    def loss(self, model: nn.Module, images: Tensor, targets: Tensor) -> Tensor:
        pred = pose_net.forward(model, images)
        if self.cfg.train.loss == "focal":
            return losses.focal_heatmap_loss(pred, targets)
        w = None if self.ch_w is None else self.ch_w.to(pred.device)
        return losses.heatmap_mse(pred, targets, w)

    def forward_backward(self, state: TrainState, batch: pipeline_mod.FrameBatch | ShardBatch,
                         draws: preprocess.AugmentDraws) -> Tensor:
        """Preprocess with the augment, forward, loss, backward: leaves the
        gradients in the parameters and returns the loss, detached. Reads
        ``batch.rgb`` and ``batch.heatmaps`` only."""
        with span("train.forward_backward"):
            pc = self.cfg.pipeline
            images = preprocess.preprocess_frame(batch.rgb, pc.render_height, pc.render_width,
                                                 augment=True, draws=draws)
            state.optimizer.zero_grad(set_to_none=True)
            loss = self.loss(state.model, images, batch.heatmaps)
            loss.backward()
            return loss.detach()

    def update(self, state: TrainState) -> TrainState:
        with span("train.update"):
            return apply_update(state)

    def __call__(self, state: TrainState, batch: pipeline_mod.FrameBatch,
                 draws: preprocess.AugmentDraws):
        loss = self.forward_backward(state, batch, draws)
        metrics = {"loss": loss, "step": state.step,
                   "visible_objects": torch.mean(torch.sum(batch.inst_visible, -1).float())}
        return self.update(state), metrics


class TrainStep:
    """``step(state, seed, frame_ids) -> (state, metrics)``: the full
    datagen + train step. ``generate(seed, frame_ids)`` gives its batch and
    augment draws; ``train_on_batch`` the rest."""

    def __init__(self, cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline):
        stride = getattr(model, "output_stride", 4)
        if stride != cfg.pipeline.heatmap_stride:
            raise ValueError(
                f"model output stride {stride} != pipeline heatmap_stride "
                f"{cfg.pipeline.heatmap_stride}: predictions and targets would have "
                "different spatial shapes")
        self.cfg, self.pipe = cfg, pipe
        mix = cfg.train.camera_mix
        self.gen = pipe.make_generate_fn(ladder=False, camera_mix=mix if mix > 0 else None)
        self.train_on_batch = BatchStep(cfg, pipe.roster)

    @torch.no_grad()
    def generate(self, seed: int, frame_ids):
        pc = self.cfg.pipeline
        fids = [int(f) for f in frame_ids]
        batch = self.gen(seed, fids)
        with span("train.augment"):
            draws = preprocess.augment_draws(seed, fids, pc.render_height, pc.render_width,
                                             self.pipe.device)
        return batch, draws

    def __call__(self, state: TrainState, seed: int, frame_ids):
        with span("train.step"):
            return self.train_on_batch(state, *self.generate(seed, frame_ids))


def make_train_step(cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline) -> TrainStep:
    return TrainStep(cfg, model, pipe)


class ShardedBatchStep(BatchStep):
    """``BatchStep`` on one rank's rows of a data-parallel batch: the loss is
    the rank's share of the global loss (focal: its terms over the global
    positives; MSE: its mean over the ranks), backpropagated times the
    world size, since DDP and FSDP2 average the ranks' gradients; the
    returned loss and ``visible_objects`` are reduced over the ranks."""

    def __init__(self, cfg: Config, roster, mesh):
        super().__init__(cfg, roster)
        self.group = mesh.get_group(mesh_mod.DATA_AXIS)
        self.world = mesh.size()

    def _sum(self, x: Tensor) -> Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, group=self.group)
        return x

    def loss(self, model: nn.Module, images: Tensor, targets: Tensor) -> Tensor:
        pred = pose_net.forward(model, images)
        if self.cfg.train.loss == "focal":
            n_pos = self._sum(torch.sum(targets > 0.9, dtype=pred.dtype))
            return losses.focal_heatmap_loss(pred, targets, n_pos=n_pos)
        w = None if self.ch_w is None else self.ch_w.to(pred.device)
        return losses.heatmap_mse(pred, targets, w) / self.world

    def forward_backward(self, state: TrainState, batch, draws) -> Tensor:
        with span("train.forward_backward"):
            pc = self.cfg.pipeline
            images = preprocess.preprocess_frame(batch.rgb, pc.render_height, pc.render_width,
                                                 augment=True, draws=draws)
            state.optimizer.zero_grad(set_to_none=True)
            part = self.loss(state.model, images, batch.heatmaps)
            (part * self.world).backward()
            return self._sum(part)

    def __call__(self, state: TrainState, batch: pipeline_mod.FrameBatch,
                 draws: preprocess.AugmentDraws):
        loss = self.forward_backward(state, batch, draws)
        vis = self._sum(torch.sum(batch.inst_visible, -1).float().mean()) / self.world
        metrics = {"loss": loss, "step": state.step, "visible_objects": vis}
        return self.update(state), metrics


class ShardedTrainStep(TrainStep):
    """``step(state, seed, frame_ids) -> (state, metrics)`` on the ranks of
    ``mesh``: ``frame_ids`` is the global batch, of which each rank
    generates and trains on its contiguous rows."""

    def __init__(self, cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline, mesh):
        super().__init__(cfg, model, pipe)
        self.mesh = mesh
        self.train_on_batch = ShardedBatchStep(cfg, pipe.roster, mesh)

    def __call__(self, state: TrainState, seed: int, frame_ids):
        with span("train.step"):
            ids = [int(f) for f in frame_ids]
            rows = [ids[i] for i in mesh_mod.batch_sharding(self.mesh, len(ids))]
            return self.train_on_batch(state, *self.generate(seed, rows))


def make_sharded_train_step(cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline,
                            mesh=None):
    """``(step, mesh, place_state)`` over the ``data`` mesh (``make_mesh()``
    by default). ``place_state(state)`` puts a state's model on the mesh:
    wrapped in DDP (the optimizer keeps its parameters), or, with
    ``cfg.train.fsdp``, sharded in place by FSDP2 with a new optimizer over
    the sharded parameters, so it takes a state with no update made yet."""
    from torch.nn.parallel import DistributedDataParallel

    mesh = mesh or mesh_mod.make_mesh(device_type=pipe.device.type)
    step = ShardedTrainStep(cfg, model, pipe, mesh)

    def place_state(state: TrainState) -> TrainState:
        if cfg.train.fsdp:
            if state.step:
                raise ValueError("place_state: FSDP shards the parameters the optimizer holds; "
                                 "place the state before its first update")
            mesh_mod.shard_params_fsdp(mesh, state.model)
            return TrainState(state.model, *make_optimizer(cfg, state.model.parameters()), 0)
        dev = next(state.model.parameters()).device
        ddp = DistributedDataParallel(state.model, device_ids=[dev] if dev.type == "cuda" else None,
                                      process_group=mesh.get_group(mesh_mod.DATA_AXIS))
        return TrainState(ddp, state.optimizer, state.scheduler, state.step)

    return step, mesh, place_state


class ShardBatch(NamedTuple):
    """The two fields of a shard batch that a training step reads."""

    rgb: Tensor  # (B, H, W, 3) uint8
    heatmaps: Tensor  # (B, C, h, w) f32


class DataTrainStep:
    """``step(state, seed, rgb, heatmaps) -> (state, metrics)``: one training
    step on a batch read from packed shards (numpy or tensors: rgb u8,
    heatmaps f16 or f32), moved to the model's device, the heatmaps to f32.
    Frame ids ``state.step * B + arange(B)`` key the augment draws, as the
    JAX step folds ``state.step * B + i`` into its seed."""

    def __init__(self, cfg: Config, model: nn.Module):
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.train_on_batch = BatchStep(cfg, world_mod.make_roster(cfg.scene))

    def draws(self, seed: int, step: int, batch: int) -> preprocess.AugmentDraws:
        pc = self.cfg.pipeline
        return preprocess.augment_draws(seed, range(step * batch, (step + 1) * batch),
                                        pc.render_height, pc.render_width, self.device)

    def __call__(self, state: TrainState, seed: int, rgb, heatmaps):
        shard = ShardBatch(torch.as_tensor(rgb).to(self.device),
                           torch.as_tensor(heatmaps).to(self.device).float())
        draws = self.draws(seed, state.step, shard.rgb.shape[0])
        metrics = {"loss": self.train_on_batch.forward_backward(state, shard, draws),
                   "step": state.step}
        return self.train_on_batch.update(state), metrics


def make_data_train_step(cfg: Config, model: nn.Module) -> DataTrainStep:
    return DataTrainStep(cfg, model)


def make_scanned_train_fn(cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline,
                          inner_steps: int = 10):
    """``run(state, seed, start_frame) -> (state, last_metrics)``: ``inner_steps``
    train steps on the contiguous frames from ``start_frame``, the metrics of
    the last."""
    return run_steps(make_train_step(cfg, model, pipe), cfg.train.batch_size, inner_steps)


def run_steps(step, batch_size: int, inner_steps: int):
    """``run(state, seed, start_frame) -> (state, last_metrics)``: ``step(state,
    seed, frame_ids)`` on ``inner_steps`` runs of ``batch_size`` contiguous
    frames from ``start_frame``."""

    def run(state: TrainState, seed: int, start_frame: int):
        metrics: Dict = {}
        for i in range(inner_steps):
            first = int(start_frame) + i * batch_size
            state, metrics = step(state, seed, range(first, first + batch_size))
        return state, metrics

    return run
