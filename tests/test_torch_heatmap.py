"""The port's heatmap targets (the plain version of the heatmap kernel)
against the JAX reference ``render_heatmaps`` and, for one small case, the
Pallas heatmap kernel in interpret mode.

Tolerance: atol 2e-4 (tests/test_ops.py), f32 rounding of exp. The Pallas
kernel drops the Gaussian beyond its +-4.25 sigma row band (< 1.3e-8 of
peak), well inside that."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from constructionsceneposeestimation_tpu.ops import heatmap as jhm
from constructionsceneposeestimation_tpu_torch.ops import heatmap
from constructionsceneposeestimation_tpu_torch.scene import world
from constructionsceneposeestimation_tpu_torch.config import SceneConfig

torch.set_num_threads(2)


def _inputs(seed, B, n, C, h, w, stride=1.0):
    rng = np.random.RandomState(seed)
    uv = rng.uniform(-10, max(h, w) * stride + 10, (B, n, 2)).astype(np.float32)
    ch = rng.randint(0, C, (B, n)).astype(np.int32)
    vis = rng.rand(B, n) > 0.3
    return uv, ch, vis


def _torch(uv, ch, vis):
    return torch.as_tensor(uv), torch.as_tensor(ch), torch.as_tensor(vis)


def test_peak_sigma_and_max_combination():
    uv = torch.tensor([[[32.0, 16.0], [36.0, 16.0], [40.0, 20.0]]])
    ch = torch.tensor([[2, 2, 0]], dtype=torch.int32)
    vis = torch.tensor([[True, True, False]])
    hm = heatmap.render_heatmaps(uv, ch, vis, 4, 32, 64, sigma=2.0)
    assert hm.shape == (1, 4, 32, 64)
    assert hm[0, 2, 16, 32] == 1.0 and hm[0, 2, 16, 36] == 1.0  # max, not sum
    np.testing.assert_allclose(hm[0, 2, 16, 30].item(), np.exp(-0.5), atol=1e-6)
    assert hm[0, 0].max() == 0.0 and hm[0, 1].max() == 0.0  # invisible / empty


@pytest.mark.parametrize("width", [128, 192])
@pytest.mark.parametrize("sigma", [1.7, 2.0, 2.7])
def test_render_heatmaps_matches_reference(sigma, width):
    """The sigma sweep at the 512^2 and 768^2 map widths (71 channels)."""
    C = 71
    uv, ch, vis = _inputs(int(sigma * 10) + width, 1, 60, C, width, width, stride=4.0)
    got = heatmap.render_heatmaps(*_torch(uv, ch, vis), C, width, width, sigma, 4)
    ref = jhm.render_heatmaps(uv[0], ch[0], vis[0], C, width, width, sigma, 4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=2e-4)
    assert got.max() > 0.5


def test_render_heatmaps_matches_pallas_kernel():
    B, n, C, h, w = 2, 40, 8, 64, 128
    uv, ch, vis = _inputs(0, B, n, C, h, w)
    got = heatmap.render_heatmaps(*_torch(uv, ch, vis), C, h, w, 2.0)
    with pltpu.force_tpu_interpret_mode():
        ref = jhm.render_heatmaps_pallas(jnp.asarray(uv), jnp.asarray(ch), jnp.asarray(vis),
                                         C, h, w, sigma=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_frame_heatmaps_matches_reference():
    roster = world.make_roster(SceneConfig())
    O, K = roster.inst_kpt_channel.shape
    rng = np.random.RandomState(3)
    kpt_uv = rng.uniform(0, 64, (2, O, K, 2)).astype(np.float32)
    kpt_vis = rng.rand(2, O, K) > 0.5
    got = heatmap.frame_heatmaps(torch.as_tensor(kpt_uv), torch.as_tensor(kpt_vis),
                                 torch.as_tensor(roster.inst_kpt_channel), 71, 16, 16, 2.0, 4)
    assert got.shape == (2, 71, 16, 16)
    for b in range(2):
        ref = jhm.frame_heatmaps(kpt_uv[b], kpt_vis[b], roster.inst_kpt_channel, 71, 16, 16,
                                 2.0, 4)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=2e-4)


def test_heatmaps_dispatch_plain_on_cpu():
    uv, ch, vis = _torch(*_inputs(5, 2, 30, 6, 16, 16, 4.0))
    before = heatmap.heatmap_cuda.launches
    got = heatmap.heatmaps(uv, ch, vis, 6, 16, 16, 2.0, 4)
    assert torch.equal(got, heatmap.render_heatmaps(uv, ch, vis, 6, 16, 16, 2.0, 4))
    assert heatmap.heatmap_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        heatmap.heatmap_cuda(uv, ch, vis, 6, 16, 16, 2.0, 4)
