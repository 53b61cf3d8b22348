"""The exact identities the RGB and heatmap kernels rely on, held on the CPU.

csrc/rgb.cu takes fract(a) as a - floor(a) instead of fmod(a, 1), culls
the contact-AO rows that cannot reach a cell of pixels, and divides the
min of (d - r) by 0.6 once instead of each row's; csrc/heatmap.cu skips a
keypoint on rows where its Gaussian underflows to 0. Each is claimed to
change no bit, and each is checked here bit for bit (no tolerance) on
numpy-seeded values and on frames of the JAX RGB tests' cameras, plus a
camera at the horizon (ground cells spanning far distances) and one
looking straight down."""

import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu_torch.config import SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.ops import heatmap
from constructionsceneposeestimation_tpu_torch.render import (raycast, rgb_kernel, shading,
                                                              sweep_kernel)
from constructionsceneposeestimation_tpu_torch.sample import placement
from constructionsceneposeestimation_tpu_torch.scene import world
from constructionsceneposeestimation_tpu_torch.utils import prng

torch.set_num_threads(2)
W, H = 80, 50  # 80 = 2.5 cull cells across: the last cell column is ragged
CAMERAS = {  # (camera positions, targets)
    "test": ([[9.0, 4.0, 3.0], [-14.0, 8.0, 6.0]], [[0.0, 0.0, 1.5], [2.0, 0.0, 1.0]]),
    "horizon": ([[0.0, -30.0, 1.6], [25.0, 5.0, 1.2]], [[0.0, 60.0, 1.6], [-60.0, 0.0, 1.2]]),
    "nadir": ([[0.1, 0.1, 25.0], [3.0, -2.0, 12.0]], [[0.0, 0.0, 0.0], [3.0, -2.01, 0.0]]),
}


@pytest.fixture(scope="module")
def frames():
    """RGB inputs of two sampled scenes per camera set, as the annotation
    pass builds them (far clip included), with the hash noise on."""
    roster = world.make_roster(SceneConfig())
    pose, _ = placement.sample_scenes([prng.generator(5, prng.SCENE_STREAM, i) for i in range(2)],
                                      roster)
    wt = world.build_world(roster, pose)
    intr = camera.intrinsics_from_apertures(12.0, 25.0, W, H)
    sweeper = sweep_kernel.PixelSweeper(roster, intr)
    out = {}
    for name, (cams, tgts) in CAMERAS.items():
        cam, tgt = torch.tensor(cams), torch.tensor(tgts)
        M = camera.look_at_matrix(cam, tgt)
        t, code = raycast._unpack(sweeper(wt, cam, M))
        t = torch.where(t < raycast.INF * 0.99, t, float("inf")).reshape(2, H, W)
        inst = (code - 2).reshape(2, H, W).to(torch.int32)
        depth = t * torch.sum(camera.pixel_rays(intr, M) * (-M[:, :, 0])[:, None, None], -1)
        clipped = depth >= 250.0
        t = torch.where(clipped, float("inf"), t).contiguous()
        inst = torch.where(clipped, -2, inst).to(torch.int32).contiguous()
        par = rgb_kernel.rgb_params(M, cam, intr, shading.default_lighting(2))
        out[name] = (t, inst, rgb_kernel.instance_table(roster, wt["inst_rot"], wt["inst_pos"]),
                     rgb_kernel.ao_table(roster, wt["inst_pos"]), par)
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


def _ao_terms(pw, ao):
    """(B, A, H, W) per-row terms clamp((d - r) / 0.6, 0, 1) and (d - r),
    in plain_rgb's operations."""
    q = lambda a, k: ao[:, a, k].reshape(-1, 1, 1)
    terms, dr = [], []
    for a in range(ao.shape[1]):
        dxa, dya = pw[0] - q(a, 0), pw[1] - q(a, 1)
        d = torch.sqrt(dxa * dxa + dya * dya)
        dr.append(d - q(a, 2))
        terms.append(torch.clamp((d - q(a, 2)) / 0.6, 0.0, 1.0))
    return torch.stack(terms, 1), torch.stack(dr, 1)


def test_fract_as_floor_equals_fmod(frames):
    """a - floor(a) == fmod(a, 1) for a >= 0: a million seeded values over
    the hash noise's range, the range's edges, and the noise's own
    arguments on every test frame."""
    rng = np.random.RandomState(0)
    vals = [rng.uniform(0.0, 43758.5453, 1_000_000).astype(np.float32),
            np.float32([0.0, 0.5, 1.0, 2.0 ** -30, 1.0 - 2.0 ** -24, 43758.5453, 2.0 ** 23])]
    for t, inst, table, ao, par in frames.values():
        pw = rgb_kernel.hit_points(t, par)[1]
        q = torch.sin(pw[0] * (12.9898 * 7.0) + pw[1] * (78.233 * 7.0) + pw[2] * (37.719 * 7.0))
        vals.append(torch.abs(q * 43758.5453).reshape(-1).numpy())
    a = torch.as_tensor(np.concatenate(vals))
    assert a.numel() > 1_000_000 and bool((a >= 0).all())
    assert torch.equal(_bits(a - torch.floor(a)), _bits(torch.fmod(a, 1.0)))


@pytest.mark.parametrize("cams", sorted(CAMERAS))
def test_ao_hoist_equals_per_row_terms(frames, cams):
    """clamp(min_a (d - r) / 0.6, 0, 1) == min(1, min_a clamp((d - r) / 0.6,
    0, 1)), bit for bit, on every pixel."""
    t, inst, table, ao, par = frames[cams]
    terms, dr = _ao_terms(rgb_kernel.hit_points(t, par)[1], ao)
    per_row = torch.clamp_max(terms.amin(1), 1.0)
    hoisted = torch.clamp(dr.amin(1) / 0.6, 0.0, 1.0)
    assert torch.equal(_bits(hoisted), _bits(per_row))
    assert bool((per_row[inst == -1] < 1.0).any())  # some ground pixel is occluded


@pytest.mark.parametrize("cams", sorted(CAMERAS))
def test_ao_cull_keeps_every_term_below_one(frames, cams):
    """Every AO row a 32 x 1 cell culls has a term of exactly 1 on every
    ground pixel of the cell."""
    t, inst, table, ao, par = frames[cams]
    keep = rgb_kernel.ao_cull_plain(t, inst, ao, par)
    cx = -(-W // 32)
    assert keep.shape == (2, H, cx, ao.shape[1])
    terms = _ao_terms(rgb_kernel.hit_points(t, par)[1], ao)[0]  # (B, A, H, W)
    ground = inst == -1
    cols = torch.arange(W) // 32
    keep_px = keep[:, :, cols].permute(0, 3, 1, 2)  # (B, A, H, W)
    culled = ~keep_px & ground[:, None]
    assert bool(culled.any()) and bool((keep_px & ground[:, None]).any())
    assert bool((terms[culled] == 1.0).all())
    # A cell with no ground pixel keeps nothing.
    empty = torch.ones(2, H, cx * 32, dtype=torch.bool)
    empty[:, :, :W] = ~ground
    empty = empty.reshape(2, H, cx, 32).all(3)
    assert not bool(keep[empty].any())


@pytest.mark.parametrize("cams", sorted(CAMERAS))
def test_plain_rgb_with_kept_rows_only(frames, cams):
    """plain_rgb with only each cell's kept AO rows (the culled ones moved
    out of reach) gives the image of plain_rgb with every row, bit for
    bit."""
    t, inst, table, ao, par = frames[cams]
    keep = rgb_kernel.ao_cull_plain(t, inst, ao, par)  # (B, H, cx, A)
    B, _, cx, A = keep.shape
    ref = rgb_kernel.plain_rgb(t, inst, table, ao, par)
    far = torch.tensor([1e4, 1e4, 0.0, 0.0])
    cols = torch.arange(W) // 32
    n_sets = 0
    for b in range(B):
        # One render per distinct set of kept rows, its culled rows 1e4 m away.
        sets, cell_set = torch.unique(keep[b].reshape(-1, A), dim=0, return_inverse=True)
        S = sets.shape[0]
        n_sets += S
        rep = lambda x: x[b:b + 1].expand(S, *x.shape[1:]).contiguous()
        ao_c = torch.where(sets[..., None], ao[b], far).contiguous()
        img = rgb_kernel.plain_rgb(rep(t), rep(inst), rep(table), ao_c, rep(par))
        px_set = cell_set.reshape(H, cx)[:, cols]  # (H, W)
        got = img[px_set, torch.arange(H)[:, None], torch.arange(W)[None, :]]
        assert torch.equal(got, ref[b])
    assert n_sets > B  # the cells keep different rows


def test_exp_underflows_below_the_skip_constant():
    """torch.exp is exactly 0 in f32 for every argument at or below
    -EXP_ZERO: all f32 values in [-112, -104], and seeded ones down to -1e4.
    Just above it exp still gives denormals, so the constant is tight."""
    lo = np.float32(-heatmap.EXP_ZERO).view(np.int32)
    hi = np.float32(-112.0).view(np.int32)  # negative floats: bits grow with magnitude
    every = np.arange(lo, hi + 1, dtype=np.int32).view(np.float32)
    rng = np.random.RandomState(1)
    seeded = -rng.uniform(heatmap.EXP_ZERO, 1e4, 100_000).astype(np.float32)
    x = torch.as_tensor(np.concatenate([every, seeded]))
    assert x.numel() > 1_000_000 and float(x.max()) == -heatmap.EXP_ZERO
    assert bool((torch.exp(x) == 0.0).all())
    assert float(torch.exp(torch.tensor(-103.9))) > 0.0


@pytest.mark.parametrize("width", [128, 192])
@pytest.mark.parametrize("sigma", [1.7, 2.0, 2.7])
def test_row_skip_keeps_every_nonzero_row(sigma, width):
    """Every (keypoint, row) the kernel's skip drops is 0 on every pixel of
    the plain version, keypoints off the map included, and the maps
    rendered with only the kept rows equal render_heatmaps bit for bit."""
    rng = np.random.RandomState(int(sigma * 10) + width)
    B, n, C, stride = 2, 120, 6, 4.0
    uv = rng.uniform(-80.0, width * stride + 80.0, (B, n, 2)).astype(np.float32)
    uv[:, :10, 1] = rng.uniform(-400.0, -60.0, 10)  # far above the map
    ch = rng.randint(0, C, (B, n)).astype(np.int32)
    vis = rng.rand(B, n) > 0.2
    uv_t, ch_t, vis_t = torch.as_tensor(uv), torch.as_tensor(ch), torch.as_tensor(vis)
    keep = heatmap.row_keep_plain(uv_t, width, sigma, stride)  # (B, n, h)
    u, v = uv_t[..., 0] / stride, uv_t[..., 1] / stride
    xs = torch.arange(width, dtype=torch.float32)
    d2 = (xs[None, None, None, :] - u[..., None, None]) ** 2 + (
        xs[None, None, :, None] - v[..., None, None]) ** 2
    g = torch.exp(-d2 / (2.0 * sigma * sigma))  # (B, n, h, w)
    nonzero_rows = (g > 0).any(-1)
    assert bool(nonzero_rows.any()) and bool((~keep).any())
    assert not bool((nonzero_rows & ~keep).any())
    g = g * (vis_t[..., None, None] & keep[..., None]).float()
    out = torch.zeros(B, C, width, width).scatter_reduce(
        1, ch_t.long()[..., None, None].expand(B, n, width, width), g, "amax",
        include_self=True)
    ref = heatmap.render_heatmaps(uv_t, ch_t, vis_t, C, width, width, sigma, stride)
    assert torch.equal(out, ref)
