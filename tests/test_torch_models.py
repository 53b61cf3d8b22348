"""The port's backbones and preprocessing against the JAX package's flax
modules, on the same numpy inputs and on flax's parameters carried over by
``convert.pose_net_params``.

Tolerances: f32 forward atol 1e-4 (cuDNN-free CPU convolutions in both, the
sums in other orders); the bf16 body (flax ``dtype=bf16`` against bf16
autocast) within 2e-2 of the output's largest magnitude, since bf16 keeps
8 bits and the two frameworks round at other places (flax keeps every
activation in bf16, autocast keeps GroupNorm and the residual sums in f32);
preprocessing atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu.models import backbone as jbackbone
from constructionsceneposeestimation_tpu.models import pose_net as jpose_net
from constructionsceneposeestimation_tpu.ops import preprocess as jpre
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.models import backbone, pose_net
from constructionsceneposeestimation_tpu_torch.ops import preprocess

torch.set_num_threads(2)
NARROW = dict(stage_features=(16, 32, 32, 64), deconv_features=32)


def _pair(kind, dtype, **kw):
    """(flax module, port module) of the same architecture."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if kind == "lite":
        return (jbackbone.LiteBackbone(num_channels=7, dtype=jdt),
                backbone.LiteBackbone(7, dtype=dtype))
    return (jbackbone.HeatmapBackbone(num_channels=7, dtype=jdt, **kw),
            backbone.HeatmapBackbone(7, dtype=dtype, **kw))


def _run(kind, dtype, size, seed=0, **kw):
    jm, tm = _pair(kind, dtype, **kw)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    tm.load_state_dict(convert.pose_net_params(params, tm))
    # f32 under jit (one compile); bf16 op by op, as flax rounds each layer's
    # output to bf16 there, while XLA's fusions under jit keep some in f32.
    fwd = (lambda p, v: jpose_net.forward(jm, p, v))
    ref = np.asarray((jax.jit(fwd) if dtype == torch.float32 else fwd)(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = pose_net.forward(tm.eval(), torch.as_tensor(x)).numpy()
    return got, ref


@pytest.mark.parametrize("kind,kw", [
    ("heatmap", dict(NARROW, output_stride=4)),
    ("heatmap", dict(NARROW, output_stride=2)),
    ("heatmap", dict(NARROW, output_stride=4, use_skips=False)),
    ("lite", {}),
])
def test_backbone_f32_matches_flax(kind, kw):
    got, ref = _run(kind, torch.float32, 64, **kw)
    stride = kw.get("output_stride", 4)
    assert got.shape == ref.shape == (2, 7, 64 // stride, 64 // stride)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_full_width_backbone_f32_matches_flax():
    """The main path's widths: stages (64, 128, 256, 512), 256-wide
    deconvolutions, skips, at a 64^2 input."""
    got, ref = _run("heatmap", torch.float32, 64, seed=1)
    assert got.shape == (2, 7, 16, 16)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_backbone_bf16_matches_flax_bf16():
    got, ref = _run("heatmap", torch.bfloat16, 32, seed=2, **NARROW)
    assert got.dtype == np.float32  # the head is f32
    err = np.abs(got - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_same_padding_and_odd_sizes():
    """flax SAME pads (2, 3) for 7x7 and (0, 1) for 3x3 at stride 2 on even
    inputs, and symmetrically on odd ones."""
    assert backbone._same_pad(64, 7, 2) == (2, 3)
    assert backbone._same_pad(64, 3, 2) == (0, 1)
    assert backbone._same_pad(63, 3, 2) == (1, 1)
    assert backbone._same_pad(64, 1, 2) == (0, 0)
    got, ref = _run("lite", torch.float32, 36)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_make_model_and_init():
    m = pose_net.make_model(device="cpu", dtype=torch.float32)
    assert isinstance(m, backbone.HeatmapBackbone) and not m.training
    assert m.head.out_channels == 71 and m.output_stride == 4
    assert [b.conv2.out_channels for b in m.blocks] == [64, 64, 128, 128, 256, 256, 512, 512]
    again = pose_net.make_model(device="cpu", dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 again.state_dict().values()))
    w = m.blocks[7].conv1.weight.detach()
    std = np.sqrt(1.0 / (3 * 3 * 512)) / 0.87962566103423978
    assert abs(float(w.std()) / std - 0.8796) < 0.02 and float(w.abs().max()) <= 2 * std
    assert pose_net.make_model(lite=True, device="cpu").output_stride == 4
    with pytest.raises(ValueError):
        pose_net.make_model(lite=True, output_stride=2, device="cpu")
    assert pose_net.class_channel_slices() == jpose_net.class_channel_slices()


def test_output_to_heatmaps():
    raw = np.random.RandomState(0).randn(2, 3, 4, 4).astype(np.float32)
    for loss in ("focal", "mse"):
        np.testing.assert_allclose(
            pose_net.output_to_heatmaps(torch.as_tensor(raw), loss).numpy(),
            np.asarray(jpose_net.output_to_heatmaps(jnp.asarray(raw), loss)), atol=1e-6)


@pytest.mark.parametrize("out_hw", [(32, 48), (96, 80), (64, 96), (40, 120)])
def test_preprocess_frame_matches_jax(out_hw):
    """Downscale, upscale, identity, and one axis each way."""
    rgb = np.random.RandomState(3).randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    got = preprocess.preprocess_frame(torch.as_tensor(rgb), *out_hw).numpy()
    ref = np.stack([np.asarray(jpre.preprocess_frame(jax.random.PRNGKey(0), jnp.asarray(f),
                                                     *out_hw, augment=False)) for f in rgb])
    assert got.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):  # the augment needs its draws (test_torch_train.py)
        preprocess.preprocess_frame(torch.as_tensor(rgb), 32, 48, augment=True)
