"""Second-stage (detect-then-crop) keypoint training (port of the JAX
``train/crop_loop.py``): the top-down pose path for equipment 6DoF.

A step generates its batch on the device (no heatmap targets), cuts one ROI
per frame around the class instance (the dumper), around the crane's four
parts (``crop_batch_crane``), or one per crane part (``crop_batch_crane_parts``,
four a frame), from the ``bbox2d`` labels jittered with detector noise,
resamples it to ``crop_size`` (``ops/crop.crop_resize``), augments it,
rasterizes the keypoints in crop coordinates (``ops/heatmap.heatmaps``: the
heatmap kernel on the card), then trains the crop net on it: the loss of
each crop (focal over its own positives, or MSE), weighted by whether its
instance is in view, then one AdamW update.

Randomness: a crop's ROI jitter (3 uniforms) and augment come from a
stream of its own per (seed, frame, part) (``utils/prng.crop_generators``),
handed to ``crop_batch`` as ``CropDraws``; the tests hand in JAX's draws
instead.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..models import pose_net
from ..ops import crop as crop_ops
from ..ops import heatmap as heatmap_ops
from ..ops import preprocess
from ..parallel import pipeline as pipeline_mod
from ..scene import assets
from ..utils import prng
from . import loop as base_loop
from . import losses

Tensor = torch.Tensor


def crane_channels(roster):
    """(s0, Kp): the crane parts' first instance and the keypoints per part
    of the crop net's 4 * Kp channel layout (part-major)."""
    s0, s1 = roster.crane_slice
    return s0, int(np.asarray(roster.inst_kpt_valid[s0:s1]).sum(1).max())


def make_crop_model(class_name: str = "dumper", lite: bool = False, roster=None,
                    output_stride: int = 4, device="cuda", seed: int = 0, **kw):
    """The crop net of ``class_name``: the class's keypoints as channels (4 *
    Kp for the crane). ``output_stride=2`` doubles the heatmap resolution
    of a crop."""
    if class_name == "crane":
        if roster is None:
            raise ValueError("the crane crop model needs the roster")
        channels = 4 * crane_channels(roster)[1]
    else:
        channels = assets.all_templates()[class_name].num_keypoints
    return pose_net.make_model(num_channels=channels, lite=lite, output_stride=output_stride,
                               device=device, seed=seed, **kw)


def create_crop_train_state(cfg: Config, model: nn.Module) -> base_loop.TrainState:
    """The crop net with a fresh AdamW. The JAX function initializes its
    parameters at the crop size; a PyTorch layer's do not depend on it."""
    return base_loop.create_train_state(cfg, model)


class CropDraws(NamedTuple):
    """The draws of N crops: ROI jitter uniform in [-1, 1) (N, 3) and the
    augment's (``preprocess.AugmentDraws``, noise (N, c, c, 3))."""

    jitter: Tensor
    augment: preprocess.AugmentDraws


def crop_draws(seed: int, frame_ids: Sequence[int], parts: int, crop_size: int,
               device="cpu") -> CropDraws:
    """The draws of ``parts`` crops of each frame, rows frame-major: eight
    uniforms from the crop's CPU stream (3 jitter, 5 augment scalars) and
    its noise image from a generator on ``device``."""
    device = torch.device(device)
    n = len(frame_ids) * parts
    u = torch.empty(n, 8)
    noise = torch.empty(n, crop_size, crop_size, 3, device=device)
    for i, f in enumerate(frame_ids):
        for p in range(parts):
            g_host, g_dev = prng.crop_generators(seed, int(f), p, device)
            u[i * parts + p] = torch.rand(8, generator=g_host)
            torch.randn(crop_size, crop_size, 3, generator=g_dev, device=device,
                        out=noise[i * parts + p])
    return CropDraws((2.0 * u[:, :3] - 1.0).to(device),
                     preprocess.draws_from_uniforms(u[:, 3:], noise))


def _finish(rgb: Tensor, roi, crop_size: int, draws: CropDraws | None, augment: bool,
            half_v: Tensor | None = None) -> Tensor:
    """Frames (B, H, W, 3) u8 and ROIs (B,) or (B, R) -> normalized crops
    (B * R, c, c, 3), augmented with ``draws`` when ``augment``."""
    cu, cv, half = roi
    img = crop_ops.crop_resize(rgb.float() / 255.0, cu, cv, half, crop_size, half_v=half_v)
    img = img.reshape(-1, crop_size, crop_size, 3)
    if augment:
        img = preprocess.photometric_augment(img, draws.augment)
    return preprocess.normalize(img)


def _targets(uvc: Tensor, vis: Tensor, crop_size: int, stride: int, sigma: float) -> Tensor:
    """Crop-space keypoints (N, K, 2) and visibility (N, K) -> (N, K, h, h):
    keypoint k on channel k, where it is visible and inside the crop."""
    N, K = vis.shape
    hm = crop_size // stride
    in_crop = ((uvc[..., 0] >= 0) & (uvc[..., 0] < crop_size)
               & (uvc[..., 1] >= 0) & (uvc[..., 1] < crop_size))
    ch = torch.arange(K, dtype=torch.int32, device=uvc.device).expand(N, K).contiguous()
    return heatmap_ops.heatmaps(uvc.contiguous(), ch, (vis & in_crop).contiguous(), K, hm, hm,
                                sigma, float(stride))


def crop_batch(batch, roster, class_name: str, crop_size: int, stride: int, sigma: float,
               draws: CropDraws | None = None, jitter: bool = True, augment: bool = True):
    """FrameBatch -> (images (B, c, c, 3), targets (B, K, h, h), sample_w
    (B,)): one square ROI a frame around the class's first instance.
    Frames where it is not in view weigh 0."""
    o = list(roster.inst_class_names).index(class_name)
    K = assets.all_templates()[class_name].num_keypoints
    roi = crop_ops.square_roi(batch.bbox2d[:, o].float())
    if jitter:
        roi = crop_ops.jitter_roi(draws.jitter, *roi)
    imgs = _finish(batch.rgb, roi, crop_size, draws, augment)
    cu, cv, half = (x[:, None] for x in roi)
    uvc = crop_ops.uv_to_crop(batch.kpt_uv[:, o, :K], cu, cv, half, crop_size)
    tgts = _targets(uvc, batch.kpt_visible[:, o, :K], crop_size, stride, sigma)
    return imgs, tgts, batch.inst_visible[:, o].float()


def crane_union_roi(batch, roster):
    """(box (B, 4), any_vis (B,)): the union of the four crane parts' boxes
    in view (-1 where none is); a part out of view does not shrink it."""
    s0, s1 = roster.crane_slice
    boxes = batch.bbox2d[:, s0:s1].float()
    vis = batch.inst_visible[:, s0:s1]
    big = 1e9
    u0 = torch.amin(torch.where(vis, boxes[..., 0], big), 1)
    v0 = torch.amin(torch.where(vis, boxes[..., 1], big), 1)
    u1 = torch.amax(torch.where(vis, boxes[..., 2], -big), 1)
    v1 = torch.amax(torch.where(vis, boxes[..., 3], -big), 1)
    any_vis = torch.any(vis, 1)
    return torch.where(any_vis[:, None], torch.stack([u0, v0, u1, v1], -1), -1.0), any_vis


def _crane_keypoints(batch, roster):
    """(uv (B, 4 * Kp, 2), visibility (B, 4 * Kp)) of the four parts,
    part-major, where the part's template has the keypoint."""
    s0, Kp = crane_channels(roster)
    B = batch.kpt_uv.shape[0]
    kvalid = roster.tensor("inst_kpt_valid", batch.kpt_uv.device)[s0:s0 + 4, :Kp]
    uv = batch.kpt_uv[:, s0:s0 + 4, :Kp].reshape(B, 4 * Kp, 2)
    vis = (batch.kpt_visible[:, s0:s0 + 4, :Kp] & kvalid).reshape(B, 4 * Kp)
    return uv, vis


def crop_batch_crane(batch, roster, crop_size: int, stride: int, sigma: float,
                     draws: CropDraws | None = None, jitter: bool = True, augment: bool = True):
    """The crane's variant of ``crop_batch``: one square ROI around the four
    parts' union; targets (B, 4 * Kp, h, h) from every part's keypoints."""
    bbox, any_vis = crane_union_roi(batch, roster)
    roi = crop_ops.square_roi(bbox)
    if jitter:
        roi = crop_ops.jitter_roi(draws.jitter, *roi)
    imgs = _finish(batch.rgb, roi, crop_size, draws, augment)
    uv, vis = _crane_keypoints(batch, roster)
    uvc = crop_ops.uv_to_crop(uv, *(x[:, None] for x in roi), crop_size)
    return imgs, _targets(uvc, vis, crop_size, stride, sigma), any_vis.float()


def crop_batch_crane_parts(batch, roster, crop_size: int, stride: int, sigma: float,
                           draws: CropDraws | None = None, jitter: bool = True,
                           augment: bool = True):
    """Per-part crane crops: four aspect-matched ROIs a frame (``rect_roi``
    with a half side of at least 24 px, one per part box) through the same
    4 * Kp-channel net; other parts' keypoints inside a crop are supervised
    too. Returns (images (B * 4, c, c, 3), targets (B * 4, 4 * Kp, h, h),
    w (B * 4,)), frame-major."""
    s0, _ = crane_channels(roster)
    B = batch.rgb.shape[0]
    cu, cv, hu, hv = crop_ops.rect_roi(batch.bbox2d[:, s0:s0 + 4].float(), min_half=24.0)
    if jitter:
        cu, cv, hu, hv = crop_ops.jitter_roi(draws.jitter.reshape(B, 4, 3), cu, cv, hu,
                                             half_v=hv)
    imgs = _finish(batch.rgb, (cu, cv, hu), crop_size, draws, augment, half_v=hv)
    uv, vis = _crane_keypoints(batch, roster)
    uvc = crop_ops.uv_to_crop(uv[:, None], *(x[..., None] for x in (cu, cv, hu)), crop_size,
                              half_v=hv[..., None])  # (B, 4, 4 * Kp, 2)
    C = uv.shape[1]
    tgts = _targets(uvc.reshape(B * 4, C, 2), vis[:, None].expand(B, 4, C).reshape(B * 4, C),
                    crop_size, stride, sigma)
    return imgs, tgts, batch.inst_visible[:, s0:s0 + 4].float().reshape(B * 4)


class CropTrainStep:
    """``step(state, seed, frame_ids) -> (state, metrics)``: generate,
    crop (``crops``), then ``train_on_crops``. The halves are separate
    methods so that tests can hand in their own batch and draws, and the
    phases can be timed apart."""

    def __init__(self, cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline,
                 class_name: str = "dumper", crop_size: int = 128, sigma: float = 1.5,
                 per_part: bool = False):
        self.cfg, self.pipe = cfg, pipe
        self.class_name, self.crop_size, self.sigma = class_name, crop_size, sigma
        self.per_part = class_name == "crane" and per_part
        self.stride = getattr(model, "output_stride", 4)
        mix = cfg.train.camera_mix
        self.gen = pipe.make_generate_fn(ladder=False, include_heatmaps=False,
                                         camera_mix=mix if mix > 0 else None)

    def crops(self, batch, draws: CropDraws):
        args = (batch, self.pipe.roster)
        size = (self.crop_size, self.stride, self.sigma, draws)
        if self.per_part:
            return crop_batch_crane_parts(*args, *size)
        if self.class_name == "crane":
            return crop_batch_crane(*args, *size)
        return crop_batch(*args, self.class_name, *size)

    @torch.no_grad()
    def generate(self, seed: int, frame_ids):
        fids = [int(f) for f in frame_ids]
        batch = self.gen(seed, fids)
        draws = crop_draws(seed, fids, 4 if self.per_part else 1, self.crop_size,
                           self.pipe.device)
        return self.crops(batch, draws)

    def loss(self, model: nn.Module, images: Tensor, targets: Tensor, sample_w: Tensor):
        pred = pose_net.forward(model, images)
        if self.cfg.train.loss == "focal":
            per = losses.focal_per_sample(pred, targets)
        else:
            per = losses.mse_per_sample(pred, targets)
        return torch.sum(per * sample_w) / torch.clamp_min(torch.sum(sample_w), 1.0)

    def forward_backward(self, state: base_loop.TrainState, images: Tensor, targets: Tensor,
                         sample_w: Tensor) -> Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(state.model, images, targets, sample_w)
        loss.backward()
        return loss.detach()

    def train_on_crops(self, state: base_loop.TrainState, images: Tensor, targets: Tensor,
                       sample_w: Tensor):
        loss = self.forward_backward(state, images, targets, sample_w)
        metrics = {"loss": loss, "step": state.step, "n_visible": torch.sum(sample_w)}
        return base_loop.apply_update(state), metrics

    def __call__(self, state: base_loop.TrainState, seed: int, frame_ids):
        return self.train_on_crops(state, *self.generate(seed, frame_ids))


def make_crop_train_step(cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline,
                         class_name: str = "dumper", crop_size: int = 128, sigma: float = 1.5,
                         per_part: bool = False) -> CropTrainStep:
    return CropTrainStep(cfg, model, pipe, class_name, crop_size, sigma, per_part)


def make_scanned_crop_train_fn(cfg: Config, model: nn.Module, pipe: pipeline_mod.Pipeline,
                               inner_steps: int = 10, class_name: str = "dumper",
                               crop_size: int = 128, sigma: float = 1.5, per_part: bool = False):
    """``run(state, seed, start_frame) -> (state, last_metrics)``:
    ``inner_steps`` crop steps on contiguous frames from ``start_frame``."""
    step = make_crop_train_step(cfg, model, pipe, class_name, crop_size, sigma, per_part)
    return base_loop.run_steps(step, cfg.train.batch_size, inner_steps)
