"""A model is a file (``models/<backbone>.py``): ``HeatmapBackbone.py``
builds the modules that the port's ``make_model`` and the plain copy built
before it, and the weights drawn on them are bit for bit the ones drawn
before; the rule for weights of any shape scales a ``Linear``, a
transposed convolution and a BatchNorm by what owns them, and raises on a
parameter it does not cover; a configuration that states what
``make_model`` cannot build is refused, naming the key."""

import math

import pytest
import torch
from torch import nn

import perfbench_tiny as tiny
from harness import configure, manifest

CELL = "world2-proxy-512.train-b32"
SEED = tiny.SEED


def _old_draw_weights(model, seed, device):
    """``configure.draw_weights`` as it was before weights of any shape."""
    params = [(n, p) for n, p in model.named_parameters()]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    total = sum(p.numel() for n, p in params if n.endswith("weight") and p.dim() == 4)
    noise = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    i = 0
    with torch.no_grad():
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


def _old_port():
    from constructionsceneposeestimation_tpu_torch.models import pose_net

    return pose_net.make_model(device="cpu")


def _old_reference(mc, num_channels):
    from reference.plain.models import backbone

    return backbone.HeatmapBackbone(
        num_channels, stage_features=mc["stage_features"],
        blocks_per_stage=mc["blocks_per_stage"], deconv_features=mc["deconv_features"],
        output_stride=mc["output_stride"], use_skips=mc["use_skips"], dtype=torch.float32)


def _layout(model):
    return [(n, tuple(p.shape), p.dtype, p.is_contiguous(memory_format=torch.channels_last),
             p.is_contiguous()) for n, p in model.named_parameters()]


def _channels():
    from constructionsceneposeestimation_tpu_torch.scene import assets

    return assets.NUM_KEYPOINT_CHANNELS


@pytest.mark.parametrize("side", ["port", "reference"])
def test_model_file_builds_what_was_built_before(side):
    cell = manifest.load_cell(CELL)
    mc, c = cell.config["model"], _channels()
    new = getattr(manifest.model(mc["backbone"]), side)(mc, c, "cpu")
    old = _old_port() if side == "port" else _old_reference(mc, c)
    assert type(new).__name__ == type(old).__name__
    assert _layout(new) == _layout(old)
    assert getattr(new, "dtype") == getattr(old, "dtype")
    configure.draw_weights(new, SEED, "cpu")
    _old_draw_weights(old, SEED, "cpu")
    for (n, a), (_, b) in zip(new.named_parameters(), old.named_parameters()):
        assert torch.equal(a, b), n


def test_build_model_draws_from_the_seed():
    """``build_model`` is the file's model with ``draw_weights`` on it."""
    cell = manifest.load_cell(CELL)
    c = _channels()
    a = configure.build_model(cell, "reference", c, SEED, "cpu")
    b = _old_reference(cell.config["model"], c)
    _old_draw_weights(b, SEED, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, groups=1)
        self.norm = nn.BatchNorm2d(4)
        self.up = nn.ConvTranspose2d(4, 2, 2, stride=2, groups=2)
        self.lin = nn.Linear(4, 5)


def test_weights_of_any_shape():
    m = _Toy()
    with torch.no_grad():
        m.norm.running_mean.fill_(3.0)
        m.norm.running_var.fill_(7.0)
        m.norm.num_batches_tracked.fill_(5)
    configure.draw_weights(m, SEED, "cpu")
    g = torch.Generator().manual_seed(SEED % (2 ** 63))
    shapes = [m.conv.weight, m.up.weight, m.lin.weight]
    noise = torch.randn(sum(p.numel() for p in shapes), generator=g).clamp_(-2.0, 2.0)
    fan_in = {"conv": 3 * 9, "up": 4 // 2 * 4, "lin": 4}
    i = 0
    for name in ("conv", "up", "lin"):
        w = getattr(m, name).weight
        want = noise[i:i + w.numel()].view(w.shape) * math.sqrt(1.0 / fan_in[name])
        assert torch.equal(w, want), name
        i += w.numel()
    for b in (m.conv.bias, m.up.bias, m.lin.bias, m.norm.bias):
        assert torch.equal(b, torch.zeros_like(b))
    assert torch.equal(m.norm.weight, torch.ones(4))
    assert torch.equal(m.norm.running_mean, torch.zeros(4))
    assert torch.equal(m.norm.running_var, torch.ones(4))
    assert int(m.norm.num_batches_tracked) == 0


@pytest.mark.parametrize("name,param", [("scale", nn.Parameter(torch.ones(3, 3))),
                                        ("gain", nn.Parameter(torch.ones(3)))])
def test_a_parameter_no_rule_covers_raises(name, param):
    m = _Toy()
    m.register_parameter(name, param)
    with pytest.raises(ValueError, match=name):
        configure.draw_weights(m, SEED, "cpu")


@pytest.mark.parametrize("key,value", [("stage_features", [64, 128, 256, 1024]),
                                       ("blocks_per_stage", [3, 4, 6, 3]),
                                       ("deconv_features", 128), ("use_skips", False),
                                       ("head_dtype", "bfloat16"), ("width_multiplier", 2)])
def test_a_width_make_model_cannot_build_raises(key, value):
    cell = manifest.load_cell(CELL)
    mc = dict(cell.config["model"], **{key: value})
    with pytest.raises(ValueError, match=key):
        manifest.model(mc["backbone"]).port(mc, _channels(), "cpu")


def test_no_harness_file_names_a_model():
    names = {p.stem for p in (tiny.BENCH / "models").glob("*.py")}
    for path in (tiny.BENCH / "harness").glob("*.py"):
        text = path.read_text()
        assert not [n for n in names if n in text], path.name
