"""The port's HRNet (``models/hrnet.py``) and its training path, on the CPU.

* The published layout, built on the ``meta`` device: 63,598,391
  parameters with 71 heatmap channels and 63,595,745 with COCO's 17 (the
  paper's 63.6 M), branches of 48/96/192/384 channels, 1/1/4/3 modules,
  292 BatchNorm layers, 293 convolutions, heatmaps at stride 4; the plain
  float32 copy (``perfbench/reference/plain/models/hrnet.py``, written
  from the paper apart from the port) has the same parameters, names and
  order, so the same drawn weights load into both.
* At a small size (width 8, stem 16, one block a unit, stages of 1, 1, 2
  and 2 modules, 64^2, 2 frames), the same weights: the port in float32 against the plain copy
  in train mode (the forward, each gradient, the running statistics after
  the step) and in eval mode (the forward by the running statistics).
  Tolerances: the forwards 1e-6 relative (the same float32 operations;
  nearest upsampling copies; 0 seen); each gradient 1e-4 of its leaf's norm
  (the backward of nearest upsampling sums each block's terms in another
  order than the plain copy's ``repeat_interleave``, and train-mode
  BatchNorm at this initialization amplifies an ulp of the gradient by up
  to ~1e4 over the net; 2e-6 seen); the running statistics 1e-6 relative.
* The bfloat16 body (the configuration's) against the plain copy: the
  train-mode output within 0.1 of its norm and the eval-mode output within
  0.08 (bfloat16 rounds every convolution's inputs by up to 2^-9, and
  train-mode BatchNorm amplifies a perturbation of a layer's input some 10
  to 40 times over the net: 4.0 to 4.6% and 1.9 to 2.5% seen); the
  control, the plain copy with every convolution weight perturbed by up to
  2^-4 of itself (e4m3's rounding), fails both (33% and 19% seen).
* ``make_train_step`` on a small HRNet in float32: two steps at 128^2
  against the plain copy trained by hand on the same batches (the focal
  loss, ``torch.optim.AdamW`` at the port's schedule): each step's loss to
  1e-5 relative, and each leaf's change, by the norm of its difference from
  the plain copy's over the norm of the plain copy's, to 1e-3 (``LEAF_CHANGE``;
  AdamW moves a weight by about lr whatever its gradient, so a leaf with a
  wrong gradient, however small, reads near 1). At 128^2 the lowest branch's
  maps are 4 x 4, so BatchNorm averages 32 values a channel over a rank's 2
  rows; at 64^2 it averages 8, whose statistics amplify the ranks' other
  order of summation further.
* ``make_sharded_train_step`` on two gloo ranks (DDP and FSDP2): against the
  same model trained in one process on each rank's rows with their own
  BatchNorm statistics, the global positives normalising the loss and the
  rows' gradients summed (the loss to 1e-5, each leaf's change to 0.1, as
  the ranks sum the gradient in another order); DDP leaves every rank with
  rank 0's running statistics updated by its own last rows, FSDP2 each rank
  with its own rows' statistics.
* The spans: ``model.forward`` around the forward, ``model.exchange``
  around each transition and each module's fuse, inside it.
* ``make_model``'s backbone choice, ``init_weights`` on BatchNorm, and the
  CLI's ``--backbone hrnet-w48`` training, evaluating with the running
  statistics.
"""

import importlib.util
import json
import math
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp
from torch import nn

from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                              SceneConfig, TrainConfig)
from constructionsceneposeestimation_tpu_torch.models import backbone, hrnet, pose_net
from constructionsceneposeestimation_tpu_torch.ops import preprocess
from constructionsceneposeestimation_tpu_torch.parallel import mesh as mesh_mod
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.train import loop, losses
from constructionsceneposeestimation_tpu_torch.utils import profiling

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(width=8, stage_modules=(1, 1, 2, 2), blocks=1, stem_features=16)
CHANNELS = 5
LR = 1e-3


def _load_plain():
    path = ROOT / "perfbench" / "reference" / "plain" / "models" / "hrnet.py"
    spec = importlib.util.spec_from_file_location("plain_hrnet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


plain = _load_plain()


def _pair(seed=0, channels=CHANNELS):
    """A small port HRNet in float32 with the port's initialization from
    ``seed``, and the plain copy with the same weights."""
    port = backbone.init_weights(hrnet.HRNet(channels, dtype=torch.float32, **SMALL), seed)
    ref = plain.HRNet(channels, **SMALL)
    ref.load_state_dict(port.state_dict())
    return port, ref


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _leaf_gaps(a: nn.Module, b: nn.Module) -> dict:
    return {n: float((p.grad - q.grad).norm() / q.grad.norm().clamp_min(1e-30))
            for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters())}


@pytest.mark.parametrize("channels,count", [(71, 63_598_391), (17, 63_595_745)])
def test_published_layout(channels, count):
    with torch.device("meta"):
        port, ref = hrnet.HRNet(channels), plain.HRNet(channels)
        out = port.head(port.body(torch.empty(1, 3, 512, 512)))
    assert sum(p.numel() for p in port.parameters()) == count
    assert [(n, p.shape) for n, p in port.named_parameters()] == [
        (n, p.shape) for n, p in ref.named_parameters()]
    assert [n for n, _ in port.named_buffers()] == [n for n, _ in ref.named_buffers()]
    norms = [m for m in port.modules() if isinstance(m, nn.BatchNorm2d)]
    assert len(norms) == 292 and all(m.momentum == 0.1 and m.eps == 1e-5 for m in norms)
    assert sum(isinstance(m, nn.Conv2d) for m in port.modules()) == 293
    assert [len(getattr(port, f"stage{s}")) for s in (2, 3, 4)] == [1, 4, 3]
    assert [b[0].conv1.in_channels for b in port.stage4[0].branches] == [48, 96, 192, 384]
    assert len(port.stage4[2].fuse_layers) == 1 and len(port.stage4[1].fuse_layers) == 4
    assert out.shape == (1, channels, 128, 128) and port.output_stride == 4


def test_port_matches_plain_copy_in_float32():
    port, ref = _pair()
    x = torch.rand(2, 3, 64, 64) * 2 - 1
    target = torch.rand(2, CHANNELS, 16, 16) ** 8
    outs = []
    for m in (port, ref):
        m.train()
        y = m(x)
        losses.focal_heatmap_loss(y, target).backward()
        outs.append(y.detach())
    assert _rel(outs[0], outs[1]) <= 1e-6
    assert max(_leaf_gaps(port, ref).values()) <= 1e-4
    for (n, a), (_, b) in zip(port.named_buffers(), ref.named_buffers()):
        if a.is_floating_point():
            assert _rel(a, b) <= 1e-6, n
        else:
            assert torch.equal(a, b) and int(a) == 1, n
    port.eval(), ref.eval()
    with torch.no_grad():
        assert _rel(port(x), ref(x)) <= 1e-6


def _outputs(model, x):
    model.train()
    with torch.no_grad():
        y = model(x)
        model.eval()
        return y, model(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_body_holds_and_the_control_fails(seed):
    port, ref = _pair(seed)
    port.dtype = torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    control = plain.HRNet(CHANNELS, **SMALL)
    control.load_state_dict({
        k: v * (1 + 2 ** -4 * (2 * torch.rand(v.shape, generator=g) - 1))
        if k.endswith("weight") and v.dim() == 4 else v for k, v in ref.state_dict().items()})
    x = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
    want_train, want_eval = _outputs(ref, x)
    got_train, got_eval = _outputs(port, x)
    ctl_train, ctl_eval = _outputs(control, x)
    assert _rel(got_train, want_train) <= 0.1 and _rel(got_eval, want_eval) <= 0.08
    assert _rel(ctl_train, want_train) > 0.1 and _rel(ctl_eval, want_eval) > 0.08


def _config(batch: int, fsdp: bool = False) -> Config:
    return Config(scene=SceneConfig(n_cones=2, n_trees=1, n_fence_panels=4),
                  pipeline=PipelineConfig(render_width=128, render_height=128),
                  train=TrainConfig(batch_size=batch, steps=2, warmup_steps=1, learning_rate=LR,
                                    loss="focal", fsdp=fsdp))


def _batches(cfg, pipe, steps, rows, seed=3):
    """The augmented images and heatmaps of ``steps`` steps of
    ``cfg.train.batch_size`` frames, generated ``rows`` at a time as the
    ranks generate them."""
    gen = pipe.make_generate_fn(ladder=False)
    B, pc = cfg.train.batch_size, cfg.pipeline
    out = []
    with torch.no_grad():
        for i in range(steps):
            parts = []
            for a in range(i * B, (i + 1) * B, rows):
                ids = range(a, a + rows)
                batch = gen(seed, ids)
                draws = preprocess.augment_draws(seed, ids, pc.render_height, pc.render_width)
                images = preprocess.preprocess_frame(batch.rgb, pc.render_height,
                                                     pc.render_width, augment=True, draws=draws)
                parts.append((images.permute(0, 3, 1, 2), batch.heatmaps))
            out.append(tuple(torch.cat(x) for x in zip(*parts)))
    return out


def _buffers(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers()}


def _load_buffers(model, values) -> None:
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(values[n])


def _hand_trained(cfg, model, batches, rows):
    """``model`` trained on ``batches`` by hand: each step's loss over the
    global positives, ``rows`` rows at a time with their own BatchNorm
    statistics, their gradients summed, one AdamW update at the port's
    schedule. Returns the losses and, for each chunk of rows, the running
    statistics that a rank training those rows holds under DDP (rank 0's
    copied to every rank before each forward) and under FSDP2 (its own)."""
    opt = torch.optim.AdamW(model.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.train.weight_decay)
    lr = loop.lr_schedule(cfg.train)
    n = batches[0][0].shape[0] // rows
    held = {"ddp": [_buffers(model)] * n, "fsdp": [_buffers(model)] * n}
    out = []
    model.train()
    for i, (images, heatmaps) in enumerate(batches):
        held["ddp"] = [held["ddp"][0]] * n
        n_pos = torch.sum(heatmaps > 0.9, dtype=torch.float32)
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for c in range(n):
            rows_c = slice(c * rows, (c + 1) * rows)
            for wrap in held:
                _load_buffers(model, held[wrap][c])
                with torch.no_grad():
                    model(images[rows_c])
                held[wrap][c] = _buffers(model)
            loss = losses.focal_heatmap_loss(model(images[rows_c]), heatmaps[rows_c],
                                             n_pos=n_pos)
            loss.backward()
            total += float(loss.detach())
        for group in opt.param_groups:
            group["lr"] = lr(i)
        opt.step()
        out.append(total)
    return out, held


def test_make_train_step_matches_the_plain_copy():
    """Two steps of the port's single-device step against the plain copy
    trained by hand on the same batches, the rows all in one chunk."""
    cfg = _config(2)
    pipe = Pipeline(cfg, device="cpu")
    port, ref = _pair(5, pipe.num_channels)
    batches = _batches(cfg, pipe, 2, rows=2)
    start = {n: p.detach().clone() for n, p in port.named_parameters()}
    state = loop.create_train_state(cfg, port)
    step = loop.make_train_step(cfg, port, pipe)
    got = [float(step(state, 3, range(i * 2, (i + 1) * 2))[1]["loss"]) for i in range(2)]
    want, _ = _hand_trained(cfg, ref, batches, rows=2)
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= 1e-5
    _assert_each_leaf_moved_alike(dict(port.named_parameters()), ref, start,
                                  LEAF_CHANGE["one"])


# A leaf's change may differ from the plain copy's by this share of its norm:
# one process reads under 1e-4 a leaf; two ranks, which sum the gradient in
# another order, up to 0.026, where AdamW divides a near-zero gradient by its
# own root. AdamW moves each weight by about the learning rate whatever its
# gradient, so a leaf whose gradient is wrong (the head, a BatchNorm scale)
# reads near 1, however small the leaf.
LEAF_CHANGE = {"one": 1e-3, "ranks": 0.1}


def _assert_each_leaf_moved_alike(params: dict, ref, start: dict, tol: float) -> None:
    """Each leaf's change in ``params`` against ``ref``'s from ``start``,
    by the norm of their difference over the norm of ``ref``'s change."""
    for n, q in ref.named_parameters():
        assert _rel(params[n].detach() - start[n], q.detach() - start[n]) <= tol, n


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WRAPS = ("ddp", "fsdp")


def _sharded_worker(rank, world, port, out_dir):
    """Each wrap's two steps on this rank, in one process group."""
    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        for wrap in WRAPS:
            cfg = _config(2 * world, fsdp=wrap == "fsdp")
            pipe = Pipeline(cfg, device="cpu")
            model, _ = _pair(5, pipe.num_channels)
            step, _, place = loop.make_sharded_train_step(cfg, model, pipe)
            state = place(loop.create_train_state(cfg, model))
            losses_ = [float(step(state, 3, range(i * 2 * world, (i + 1) * 2 * world))[1]["loss"])
                       for i in range(2)]
            inner = getattr(state.model, "module", state.model)
            params = {}
            for n, p in inner.named_parameters():
                full = p.full_tensor() if hasattr(p, "full_tensor") else p
                params[n] = full.detach().clone()
            torch.save({"loss": losses_, "params": params,
                        "buffers": {n: b.clone() for n, b in inner.named_buffers()}},
                       Path(out_dir) / f"{wrap}{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Both wraps' ranks, spawned once, and the plain copy trained by hand
    on each rank's rows: (results dir, losses, held statistics, start and
    end weights)."""
    world, out = 2, tmp_path_factory.mktemp("sharded")
    mp.start_processes(_sharded_worker, args=(world, _free_port(), str(out)),
                       nprocs=world, start_method="spawn")
    cfg = _config(2 * world)
    pipe = Pipeline(cfg, device="cpu")
    _, ref = _pair(5, pipe.num_channels)
    start = {n: p.detach().clone() for n, p in ref.named_parameters()}
    want, kept = _hand_trained(cfg, ref, _batches(cfg, pipe, 2, rows=2), rows=2)
    return out, want, kept, start, ref


@pytest.mark.parametrize("wrap", WRAPS)
def test_sharded_step_keeps_each_ranks_statistics(wrap, sharded):
    out, want, kept, start, ref = sharded
    for rank in range(2):
        got = torch.load(out / f"{wrap}{rank}.pt")
        assert max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want)) <= 1e-5
        _assert_each_leaf_moved_alike(got["params"], ref, start, LEAF_CHANGE["ranks"])
        for n, b in got["buffers"].items():
            w = kept[wrap][rank][n]
            assert (torch.equal(b, w) if not b.is_floating_point() else _rel(b, w) <= 1e-5), n
    if wrap == "ddp":  # rank 1 holds rank 0's statistics of step 1, then its own rows'
        first = torch.load(out / "ddp0.pt")["buffers"]
        other = torch.load(out / "ddp1.pt")["buffers"]
        assert not torch.equal(first["bn1.running_mean"], other["bn1.running_mean"])


def test_spans_of_the_forward_and_the_exchanges(tmp_path):
    """Under a profiler the forward opens ``model.forward`` and, inside it,
    one ``model.exchange`` for each transition (3) and each module's fuse
    (1 + 2 + 2); with none active the forward records nothing."""
    port, _ = _pair()
    x = torch.rand(1, 3, 64, 64)
    with profiling.trace(str(tmp_path)):
        port(x)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (fwd,) = [e for e in spans if e["name"] == "model.forward"]
    inside = [e for e in spans if e["name"] == "model.exchange"]
    assert len(inside) == 8
    assert all(fwd["ts"] <= e["ts"] and e["ts"] + e["dur"] <= fwd["ts"] + fwd["dur"]
               for e in inside)


def test_make_model_backbones_and_batchnorm_init():
    m = pose_net.make_model(device="cpu", backbone="hrnet_w48")
    assert isinstance(m, hrnet.HRNet) and not m.training and m.dtype == torch.bfloat16
    assert type(pose_net.make_model(device="cpu", lite=True)).__name__ == "LiteBackbone"
    assert type(pose_net.make_model(device="cpu", backbone="lite")).__name__ == "LiteBackbone"
    for kw in ({"lite": True, "backbone": "hrnet_w48"}, {"backbone": "hrnet"},
               {"backbone": "hrnet_w48", "output_stride": 2}):
        with pytest.raises(ValueError):
            pose_net.make_model(device="cpu", **kw)
    small = hrnet.HRNet(CHANNELS, **SMALL)
    with torch.no_grad():
        for norm in (x for x in small.modules() if isinstance(x, nn.BatchNorm2d)):
            norm.weight.fill_(3.0), norm.bias.fill_(2.0), norm.running_mean.fill_(4.0)
            norm.running_var.fill_(5.0), norm.num_batches_tracked.fill_(7)
    backbone.init_weights(small, 0)
    for norm in (x for x in small.modules() if isinstance(x, nn.BatchNorm2d)):
        assert bool((norm.weight == 1).all() and (norm.bias == 0).all())
        assert bool((norm.running_mean == 0).all() and (norm.running_var == 1).all())
        assert int(norm.num_batches_tracked) == 0
    conv = small.stage2[0].branches[0][0].conv1.weight
    assert 0.5 < float(conv.std() * math.sqrt(conv[0].numel())) < 1.5


def test_cli_trains_and_evaluates_hrnet():
    """``train-eval --backbone hrnet-w48`` at 64^2 trains one step in train
    mode and evaluates in eval mode (the running statistics)."""
    out = subprocess.run(
        [sys.executable, "-m", "constructionsceneposeestimation_tpu_torch.cli", "train-eval",
         "--device", "cpu", "--backbone", "hrnet-w48", "--size", "64", "--batch", "2",
         "--steps", "1", "--eval-frames", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step 1: loss=") and re.search(r"model PCK@0\.5: ", lines[2])
