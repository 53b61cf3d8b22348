"""Detector training (port of the JAX ``train/detect_loop.py``): a CenterNet
head (``ops/detect.py``) over the shared backbone, stage 1 of the two-stage
deployment path.

A step generates its batch on the device (no heatmap targets), augments the
frames as the stage-1 step does (``preprocess.augment_draws``: a frame's
draws depend on (seed, frame id) only), builds each frame's targets from
its boxes with the whole crane appended as one more instance
(``crane_extended_boxes``), and takes the mean over frames of each frame's
``detection_loss``, then one AdamW update. With ``hifi_pipe`` and
``hifi_every=k`` every k-th step (``state.step % k == 0``) renders its batch
through the hifi CAD-mesh pipeline instead: mixed-geometry training for the
sim-to-sim gap that ``--hifi-eval`` measures. ``make_data_detect_train_step``
is the same step on batches read from packed shards.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..models import pose_net
from ..ops import detect as detect_ops
from ..ops import preprocess
from ..parallel import pipeline as pipeline_mod
from . import crop_loop
from . import loop as base_loop

Tensor = torch.Tensor
_Boxes = collections.namedtuple("_Boxes", ["bbox2d", "inst_visible"])


def make_detect_model(lite: bool = False, output_stride: int = 4, device="cuda",
                      seed: int = 0, **kw):
    """The detector: C + 4 = 14 output channels. ``output_stride=2``
    doubles the map resolution for small classes at range."""
    return pose_net.make_model(num_channels=len(detect_ops.DET_CLASSES) + 4, lite=lite,
                               output_stride=output_stride, device=device, seed=seed, **kw)


def extended_inst_classes(roster) -> np.ndarray:
    """(O + 1,) detection class per instance, the union "crane"
    pseudo-instance appended (pairs with ``crane_extended_boxes``)."""
    return np.concatenate([detect_ops.det_class_of_instances(roster),
                           [detect_ops.DET_CLASSES.index("crane")]]).astype(np.int32)


def crane_extended_boxes(batch, roster):
    """(bbox (B, O + 1, 4), vis (B, O + 1)): every instance's own box (the
    crane parts train their part classes) plus the four parts' union box
    for the "crane" class."""
    merged, any_vis = crop_loop.crane_union_roi(batch, roster)
    bbox = torch.cat([batch.bbox2d.float(), merged[:, None]], 1)
    return bbox, torch.cat([batch.inst_visible, any_vis[:, None]], 1)


class DetectBatchStep:
    """The detector's loss on a batch of frames, its gradients and one
    update, for one config and roster."""

    def __init__(self, cfg: Config, model: nn.Module, roster):
        self.cfg, self.roster = cfg, roster
        self.stride = getattr(model, "output_stride", 4)
        self.inst_cls = torch.as_tensor(extended_inst_classes(roster))
        self.cls_w = torch.as_tensor(detect_ops.CLASS_LOSS_WEIGHTS, dtype=torch.float32)

    def loss(self, model: nn.Module, images: Tensor, bbox: Tensor, vis: Tensor) -> Tensor:
        pred = pose_net.forward(model, images)  # (B, C + 4, h, w)
        pc = self.cfg.pipeline
        tgt = detect_ops.build_targets(bbox, vis, self.inst_cls, pc.render_height // self.stride,
                                       pc.render_width // self.stride, float(self.stride))
        per, _ = detect_ops.detection_loss(pred, *tgt, class_weights=self.cls_w.to(pred.device))
        return torch.mean(per)

    def forward_backward(self, state: base_loop.TrainState, rgb: Tensor, boxes,
                         draws: preprocess.AugmentDraws) -> Tensor:
        """Augment and preprocess ``rgb`` (B, H, W, 3) u8, then the loss of
        ``boxes`` (``bbox2d``, ``inst_visible``) and its backward; returns
        the loss, detached."""
        pc = self.cfg.pipeline
        images = preprocess.preprocess_frame(rgb, pc.render_height, pc.render_width,
                                             augment=True, draws=draws)
        bbox, vis = crane_extended_boxes(boxes, self.roster)
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(state.model, images, bbox, vis)
        loss.backward()
        return loss.detach()

    def __call__(self, state: base_loop.TrainState, rgb: Tensor, boxes,
                 draws: preprocess.AugmentDraws):
        metrics = {"loss": self.forward_backward(state, rgb, boxes, draws), "step": state.step}
        return base_loop.apply_update(state), metrics


class DetectTrainStep:
    """``step(state, seed, frame_ids) -> (state, metrics)``: generate the
    frames (through ``hifi_pipe`` on every ``hifi_every``-th step) and their
    augment draws, then ``train_on_batch``."""

    def __init__(self, cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline,
                 hifi_pipe: pipeline_mod.Pipeline | None = None, hifi_every: int = 0):
        self.cfg, self.pipe = cfg, pipe
        mix = cfg.train.camera_mix
        mix = mix if mix > 0 else None
        self.gen = pipe.make_generate_fn(ladder=False, include_heatmaps=False, camera_mix=mix)
        self.gen_hifi, self.hifi_every = None, hifi_every
        if hifi_pipe is not None and hifi_every > 0:
            self.gen_hifi = hifi_pipe.make_generate_fn(ladder=False, include_heatmaps=False,
                                                       camera_mix=mix)
        self.train_on_batch = DetectBatchStep(cfg, model, pipe.roster)

    @torch.no_grad()
    def generate(self, seed: int, frame_ids, step: int):
        """The batch of step ``step`` and its augment draws."""
        pc = self.cfg.pipeline
        fids = [int(f) for f in frame_ids]
        hifi = self.gen_hifi is not None and step % self.hifi_every == 0
        batch = (self.gen_hifi if hifi else self.gen)(seed, fids)
        return batch, preprocess.augment_draws(seed, fids, pc.render_height, pc.render_width,
                                               self.pipe.device)

    def __call__(self, state: base_loop.TrainState, seed: int, frame_ids):
        batch, draws = self.generate(seed, frame_ids, state.step)
        return self.train_on_batch(state, batch.rgb, batch, draws)


def make_detect_train_step(cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline,
                           hifi_pipe: pipeline_mod.Pipeline | None = None,
                           hifi_every: int = 0) -> DetectTrainStep:
    return DetectTrainStep(cfg, model, pipe, hifi_pipe, hifi_every)


class DataDetectTrainStep:
    """``step(state, seed, rgb, bbox2d, inst_visible) -> (state, metrics)``
    on a batch read from packed shards (numpy or tensors), moved to the
    model's device. Frame ids ``state.step * B + arange(B)`` key the
    augment draws, as the JAX step folds ``state.step * B + i`` into its
    seed."""

    def __init__(self, cfg: Config, model: nn.Module, roster):
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.train_on_batch = DetectBatchStep(cfg, model, roster)

    def draws(self, seed: int, step: int, batch: int) -> preprocess.AugmentDraws:
        pc = self.cfg.pipeline
        return preprocess.augment_draws(seed, range(step * batch, (step + 1) * batch),
                                        pc.render_height, pc.render_width, self.device)

    def __call__(self, state: base_loop.TrainState, seed: int, rgb, bbox2d, inst_visible):
        t = lambda x: torch.as_tensor(x).to(self.device)
        rgb = t(rgb)
        boxes = _Boxes(t(bbox2d).float(), t(inst_visible))
        return self.train_on_batch(state, rgb, boxes, self.draws(seed, state.step, rgb.shape[0]))


def make_data_detect_train_step(cfg: Config, model: nn.Module, roster) -> DataDetectTrainStep:
    return DataDetectTrainStep(cfg, model, roster)


def make_scanned_detect_train_fn(cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline,
                                 inner_steps: int = 10,
                                 hifi_pipe: pipeline_mod.Pipeline | None = None,
                                 hifi_every: int = 0):
    """``run(state, seed, start_frame) -> (state, last_metrics)``:
    ``inner_steps`` detector steps on contiguous frames from
    ``start_frame``."""
    return base_loop.run_steps(make_detect_train_step(cfg, model, pipe, hifi_pipe, hifi_every),
                               cfg.train.batch_size, inner_steps)
