"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit; elsewhere they skip. They
import no JAX, so on a host without it run them without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of the CPU parity tests (tests/test_torch_raycast.py,
test_torch_rgb.py, test_torch_heatmap.py), on the TPU kernel's own test
cameras. The peak kernel's blur, NMS and selection are bit-equal to its
plain version by construction (csrc/peaks.cu), its DARK offsets are held
to 1e-3 heatmap px. The sweep's 2e-4 bound on relative t excludes grazing rays (disc
~ 0 on a quadric, or a flip to the surface behind), which measured 7.2e-6
of 9.7M hit pixels at 64 x 512^2: up to 1e-4 of the hit pixels may exceed
it."""

import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.ops import decode, heatmap, peak_kernel
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import FrameBatch, Pipeline
from constructionsceneposeestimation_tpu_torch.render import raycast, rgb_kernel, sweep_kernel
from constructionsceneposeestimation_tpu_torch.sample import placement
from constructionsceneposeestimation_tpu_torch.scene import world
from constructionsceneposeestimation_tpu_torch.utils import prng

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene(dev):
    roster = world.make_roster(SceneConfig())
    pose, _ = placement.sample_scenes([prng.generator(5, prng.SCENE_STREAM, 0)] * 3, roster,
                                      device=dev)
    cam = torch.tensor([[9.0, 4.0, 3.0], [-14.0, 8.0, 6.0], [0.1, 0.1, 25.0]], device=dev)
    tgt = torch.tensor([[0.0, 0.0, 1.5], [2.0, 0.0, 1.0], [0.0, 0.0, 0.0]], device=dev)
    return roster, world.build_world(roster, pose), cam, tgt


def test_sweep_kernel_matches_plain(scene):
    roster, w, cam, tgt = scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 256, 192)
    sweeper = sweep_kernel.PixelSweeper(roster, intr)
    M = camera.look_at_matrix(cam, tgt)
    before = sweep_kernel.sweep_cuda.launches
    tk, ck = raycast._unpack(sweeper(w, cam, M))
    assert sweep_kernel.sweep_cuda.launches == before + 1
    tp, cp = raycast._unpack(sweep_kernel.plain_pixel_sweep(sweeper.caster, w, cam, M, intr))
    torch.cuda.synchronize()
    hk, hp = tk < raycast.INF * 0.99, tp < raycast.INF * 0.99
    assert (hk == hp).float().mean() > 0.9995
    both = hk & hp
    rel = (torch.abs(tk - tp) / tp)[both]
    assert (rel > 2e-4).float().mean() < 1e-4
    assert (rel > 1e-5).float().mean() < 0.005
    assert (ck[both] == cp[both]).float().mean() > 0.999


@pytest.mark.parametrize("noise", [False, True])
def test_rgb_kernel_matches_plain(scene, noise):
    roster, w, cam, tgt = scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 128, 96)
    M = camera.look_at_matrix(cam, tgt)
    t, code = raycast._unpack(sweep_kernel.PixelSweeper(roster, intr)(w, cam, M))
    t = torch.where(t < raycast.INF * 0.99, t, float("inf")).reshape(3, 96, 128).contiguous()
    inst = (code - 2).reshape(3, 96, 128).to(torch.int32)
    inst = torch.where(torch.isfinite(t), inst, -2).to(torch.int32).contiguous()
    from constructionsceneposeestimation_tpu_torch.render.shading import default_lighting
    lit = default_lighting(3, cam.device)
    if not noise:
        lit = lit._replace(tex_strength=torch.zeros(3, device=cam.device))
    args = (t, inst, rgb_kernel.instance_table(roster, w["inst_rot"], w["inst_pos"]),
            rgb_kernel.ao_table(roster, w["inst_pos"]), rgb_kernel.rgb_params(M, cam, intr, lit))
    a = rgb_kernel.fused_rgb(*args).float()
    b = rgb_kernel.plain_rgb(*args).float()
    torch.cuda.synchronize()
    if noise:
        assert abs(a.mean() - b.mean()) < 1.0 and abs(a.std() - b.std()) < 2.0
    else:
        d = torch.abs(a - b)
        assert d.mean() < 0.5 and (d > 1).float().mean() < 0.02
        sky = inst == -2
        assert sky.any() and torch.equal(a[sky], b[sky])


@pytest.mark.parametrize("width", [128, 192])
@pytest.mark.parametrize("sigma", [1.7, 2.0, 2.7])
def test_heatmap_kernel_matches_plain(dev, sigma, width):
    rng = np.random.RandomState(int(sigma * 10) + width)
    B, n, C = 2, 680, 71
    uv = torch.tensor(rng.uniform(-10, 4 * width + 10, (B, n, 2)), dtype=torch.float32,
                      device=dev)
    ch = torch.tensor(rng.randint(0, C, (B, n)), dtype=torch.int32, device=dev)
    vis = torch.tensor(rng.rand(B, n) > 0.8, device=dev)
    a = heatmap.heatmaps(uv, ch, vis, C, width, width, sigma, 4)
    b = heatmap.render_heatmaps(uv, ch, vis, C, width, width, sigma, 4)
    torch.cuda.synchronize()
    assert torch.abs(a - b).max() < 2e-4


def test_generate_on_cuda_matches_cpu(dev):
    cfg = Config(pipeline=PipelineConfig(render_width=64, render_height=64, batch_size=4))
    counters = (sweep_kernel.sweep_cuda, rgb_kernel.rgb_cuda, heatmap.heatmap_cuda)
    before = [c.launches for c in counters]
    g = Pipeline(cfg, device=dev).make_generate_fn()(3, range(10, 14))
    assert all(c.launches > n for c, n in zip(counters, before))
    c = Pipeline(cfg, device="cpu").make_generate_fn()(3, range(10, 14))
    for f in FrameBatch._fields:
        assert getattr(g, f).device.type == "cuda", f
    assert (g.instance.cpu() == c.instance).float().mean() > 0.999
    fin = torch.isfinite(g.depth.cpu()) & torch.isfinite(c.depth)
    assert torch.allclose(g.depth.cpu()[fin], c.depth[fin], rtol=3e-4)
    assert torch.equal(g.kpt_in_image.cpu(), c.kpt_in_image)
    assert torch.allclose(g.kpt_uv.cpu(), c.kpt_uv, atol=1e-3)
    assert torch.allclose(g.heatmaps.cpu(), c.heatmaps, atol=2e-4)


@pytest.mark.parametrize("shape", [(2, 71, 128, 128), (3, 5, 37, 61), (7, 3, 3)])
def test_peak_kernel_matches_plain(dev, shape):
    """Blobs, noise with negative values, an odd shape and N = 15 maps, and
    3 x 3 maps."""
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32) * 0.1
    H, W = shape[-2:]
    yy, xx = np.mgrid[:H, :W]
    for _ in range(4):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        x += rng.uniform(0.3, 1.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    hm = torch.tensor(x, device=dev)
    before = peak_kernel.peaks_cuda.launches
    uv, sc = decode.extract_peaks(hm, 8)
    assert peak_kernel.peaks_cuda.launches == before + 1
    uv_p, sc_p = peak_kernel.extract_peaks_plain(hm, 8)
    torch.cuda.synchronize()
    assert uv.shape == (*shape[:-2], 8, 2) and sc.shape == (*shape[:-2], 8)
    assert torch.equal(sc, sc_p)
    assert torch.abs(uv - uv_p).max() <= 1e-3


def test_peak_kernel_refuses_oversize_maps(dev):
    """A map that does not fit one block's shared memory raises; it never
    falls back to the plain version."""
    before = peak_kernel.peaks_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        decode.extract_peaks(torch.zeros(1, 192, 192, device=dev), 8)
    with pytest.raises(ValueError):
        peak_kernel.peaks_cuda(torch.zeros(1, 2, 16, device=dev))
    assert peak_kernel.peaks_cuda.launches == before
