"""HRNet-W48 as a model file (``models/HRNetW48.py``): ``port`` builds what
the port's ``make_model(backbone="hrnet_w48")`` builds, and ``reference``
the plain copy with the same parameter names and shapes, so that
``draw_weights`` covers every parameter and gives both the same weights; a
configuration that states what ``make_model`` cannot build is refused,
naming the key; the file's ``weights`` draws both sides alike, the head at
the published scale. The readers of the port's ``model.forward`` and
``model.exchange`` spans, ``model_fwd_ms.train`` and
``exchange_fwd_ms.train``, read their exact numbers from a trace written
by hand, and nothing without the spans."""

import math

import pytest
import torch
from torch import nn

import perfbench_tiny as tiny
from harness import configure, manifest, tracing

SEED = tiny.SEED
# The model of an HRNet-W48 configuration as the official
# w48_384x288_adam_lr1e-3 layout states it, the body in bfloat16.
MODEL = {"backbone": "HRNetW48", "width": 48, "stage_modules": [1, 1, 4, 3], "blocks": 4,
         "stem_features": 64, "bn_momentum": 0.1, "bn_eps": 1e-5, "output_stride": 4,
         "body_dtype": "bfloat16", "head_dtype": "float32"}


def _file():
    return manifest.model(MODEL["backbone"])


def _channels():
    from constructionsceneposeestimation_tpu_torch.scene import assets

    return assets.NUM_KEYPOINT_CHANNELS


def _layout(model):
    return [(n, tuple(p.shape), p.dtype, p.is_contiguous(memory_format=torch.channels_last),
             p.is_contiguous()) for n, p in model.named_parameters()]


@pytest.fixture(scope="module")
def built():
    """The file's port and reference, and ``make_model``'s HRNet-W48."""
    from constructionsceneposeestimation_tpu_torch.models import pose_net

    mc, mod, c = MODEL, _file(), _channels()
    return (mod.port(mc, c, "cpu"), mod.reference(mc, c, "cpu"),
            pose_net.make_model(c, device="cpu", backbone="hrnet_w48"))


def test_port_builds_what_make_model_builds(built):
    port, _, made = built
    assert type(port) is type(made) and port.dtype == made.dtype == torch.bfloat16
    assert _layout(port) == _layout(made)
    assert [n for n, _ in port.named_buffers()] == [n for n, _ in made.named_buffers()]
    assert port.output_stride == 4 and port.head.out_channels == _channels()


def test_draw_weights_covers_every_parameter_alike(built):
    """Every parameter is drawn (convolutions by their fan-in, BatchNorm's
    scale 1 and bias 0, the head's bias 0), the running statistics reset,
    and the port and the plain copy get the same weights from a seed."""
    port, ref, _ = built
    assert [(n, p.shape) for n, p in port.named_parameters()] == [
        (n, p.shape) for n, p in ref.named_parameters()]
    for m in (port, ref):
        configure.draw_weights(m, SEED, "cpu")
    for (n, a), (_, b) in zip(port.named_parameters(), ref.named_parameters()):
        assert torch.equal(a, b), n
    for name, m in port.named_modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * math.prod(m.kernel_size)
            scale = float(m.weight.detach().std() * math.sqrt(fan_in))
            assert 0.5 < scale < 1.2, name  # a normal clipped at 2 std: 0.88
        elif isinstance(m, nn.BatchNorm2d):
            assert bool((m.weight == 1).all() and (m.bias == 0).all()), name
            assert bool((m.running_mean == 0).all() and (m.running_var == 1).all()), name
            assert int(m.num_batches_tracked) == 0, name
    assert bool((port.head.bias == 0).all())


def test_configuration_states_the_published_layout():
    cell = manifest.load_cell("world2-proxy-512-hrnet-w48.train-b32")
    assert cell.config["model"] == MODEL
    assert cell.config["resolution"] == [512, 512] and cell.mix["batch"] == 32


def test_weights_draw_both_sides_alike_with_the_head_at_the_published_scale(built):
    """``weights`` is ``draw_weights`` but for the head's weight, scaled to
    std 0.001 (clamped at 2 std, so that its std reads some 0.96 of that)."""
    port, ref, _ = built
    drawn = {}
    for m in (port, ref):
        _file().weights(m, SEED, "cpu")
    for (n, a), (_, b) in zip(port.named_parameters(), ref.named_parameters()):
        assert torch.equal(a, b), n
        drawn[n] = a.detach().clone()
    configure.draw_weights(port, SEED, "cpu")
    for n, p in port.named_parameters():
        if n != "head.weight":
            assert torch.equal(p, drawn[n]), n
    head = drawn["head.weight"]
    assert torch.allclose(head, port.head.weight.detach() * 0.001 * math.sqrt(48), rtol=1e-6)
    assert 0.0009 < float(head.std()) < 0.001 and float(head.abs().max()) <= 0.002 + 1e-9
    assert configure.build_model(manifest.load_cell("world2-proxy-512-hrnet-w48.train-b32"),
                                 "reference", _channels(), SEED, "cpu").head.weight.equal(head)


@pytest.mark.parametrize("key,value", [("width", 32), ("stage_modules", [1, 1, 4, 2]),
                                       ("blocks", 2), ("stem_features", 32),
                                       ("bn_momentum", 0.01), ("bn_eps", 1e-3),
                                       ("output_stride", 2), ("head_dtype", "bfloat16"),
                                       ("width_multiplier", 2)])
def test_a_width_make_model_cannot_build_raises(key, value):
    with pytest.raises(ValueError, match=key):
        _file().port(dict(MODEL, **{key: value}), _channels(), "cpu")


def test_head_is_the_one_module_the_control_leaves():
    assert _file().HEAD == ("head",)


def _x(cat, name, a, b, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(a), "dur": float(b - a), **kw}


# Two steps of 1000 us. Each launches a kernel before the forward (the
# generate), one in the forward outside an exchange, one in each of two
# exchanges (inside the forward, so counted), and one after the forward has
# closed (the backward).
LAUNCHES = ((50, 40), (150, 30), (210, 20), (320, 15), (500, 100))
SPANS = (("model.forward", 100, 400), ("model.exchange", 200, 250),
         ("model.exchange", 300, 350))


def _trace(program=True):
    ev = [_x("user_annotation", tracing.WINDOW, 0, 2000)]
    corr = 0
    for o in (0, 1000):
        ev.append(_x("user_annotation", "forward_backward", o + 90, o + 700, tid=1))
        if program:
            ev += [_x("user_annotation", n, o + a, o + b, tid=1) for n, a, b in SPANS]
        for t, dur in LAUNCHES:
            corr += 1
            ev.append(_x("cuda_runtime", "cudaLaunchKernel", o + t, o + t + 5,
                         args={"correlation": corr}))
            ev.append(_x("kernel", f"k{t}", o + t + 6, o + t + 6 + dur,
                         args={"correlation": corr}))
    return tracing.Trace(ev, 2, tracing.Spans(), 2, frozenset())


def test_model_span_reader_reads_its_exact_number():
    read = manifest.reader("model_fwd_ms.train")
    assert read(_trace()) == pytest.approx(0.065, abs=1e-12)
    assert read(_trace(program=False)) is None


def test_exchange_span_reader_reads_its_exact_number():
    read = manifest.reader("exchange_fwd_ms.train")
    assert read(_trace()) == pytest.approx(0.035, abs=1e-12)
    assert read(_trace(program=False)) is None
