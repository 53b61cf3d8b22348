"""The port's image-texture tier against the JAX package's: the factor
tables, ``sample``, the dense texel table, ``apply_image_textures``,
``perturb_normal``, the roughness specular of ``shade``, and the textured
plain version of the RGB kernel against JAX's textured ``jnp`` tier.

Tolerances: texture values to 1e-6 (f32 sums of 12 products in another
order). ``apply_image_textures`` computes theta with atan2, which XLA and
PyTorch round differently in the last ulp on ~17% of inputs, so a sample
whose theta * 512 sits on a bin edge may take the next texel: at most 1e-4
of the values may exceed 1e-6. Rendered RGB: the tolerances of
tests/test_torch_rgb.py (noise off: mean |d| < 0.5 u8, |d| > 1 on < 2% of
the values, sky exact)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.render import annotate as jann
from constructionsceneposeestimation_tpu.render import raycast as jrc
from constructionsceneposeestimation_tpu.render import shading as jsh
from constructionsceneposeestimation_tpu.render import textures as jtx
from constructionsceneposeestimation_tpu.sample import lighting as jlit
from constructionsceneposeestimation_tpu.sample import placement as jpl
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.render import (annotate, raycast, rgb_kernel,
                                                              shading as sh, sweep_kernel,
                                                              textures)
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
JCFG = JConfig()
W, H = 64, 48
T = lambda a: torch.as_tensor(np.array(a, np.float32))


@pytest.fixture(scope="module")
def factors():
    return textures.load_factors(), jtx.load_factors()


@pytest.fixture(scope="module")
def texels(factors):
    return textures.dense_table(factors[0])


def test_factor_tables_match_jax(factors):
    mine, ref = factors
    assert (mine.bins, mine.rank, mine.n_tex) == (ref.bins, ref.rank, ref.n_tex) == (128, 12, 13)
    np.testing.assert_array_equal(mine.U.numpy(), np.asarray(ref.U))
    np.testing.assert_array_equal(mine.V.numpy(), np.asarray(ref.V))
    assert mine.U.dtype == torch.float32
    assert textures.TEX == jtx.TEX


def test_sample_matches_jax_on_wrapped_coordinates(factors):
    mine, ref = factors
    rng = np.random.RandomState(3)
    n = 20000
    # Negative, wrapped (|u| up to 40 tiles) and in-tile coordinates.
    u = np.concatenate([rng.uniform(-40, 40, n // 2), rng.uniform(0, 1, n // 2)]).astype(np.float32)
    v = np.concatenate([rng.uniform(-7, 3, n // 2), rng.uniform(-1, 0, n // 2)]).astype(np.float32)
    tex = rng.randint(0, 13, n).astype(np.int32)
    got = textures.sample(mine, T(u), T(v), torch.as_tensor(tex))
    want = jtx.sample(ref, jnp.asarray(u), jnp.asarray(v), jnp.asarray(tex))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    # The dense table's texel at the same bins is the same value.
    dense = textures.sample_texels(textures.dense_table(mine), T(u), T(v), torch.as_tensor(tex))
    for a, b in zip(dense, got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_dense_table_matches_low_rank_product(factors, texels):
    mine = factors[0]
    T_, B, K = mine.n_tex, mine.bins, mine.rank
    U = mine.U.numpy().astype(np.float64).reshape(T_, B, 3, K)
    V = mine.V.numpy().astype(np.float64).reshape(T_, B, 3, K)
    want = np.clip(np.einsum("tuck,tvck->tuvc", U, V), 0.0, 1.0)
    assert texels.shape == (13, 128, 128, 4) and texels.dtype == torch.float32
    np.testing.assert_allclose(texels[..., :3].numpy(), want, rtol=0, atol=1e-6)
    assert not texels[..., 3].any()


def _class_planes(n, rng):
    """Local and world coordinates over every class's texture bands."""
    cls = rng.choice([-2, -1, 0, 1, 2, 4, 5, 8], n).astype(np.float32)
    lx = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    ly = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    lz = rng.uniform(0.0, 4.0, n).astype(np.float32)
    pwx = rng.uniform(-25, 25, n).astype(np.float32)
    pwy = rng.uniform(-25, 25, n).astype(np.float32)
    alb = tuple(rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    return cls, lx, ly, lz, pwx, pwy, alb


def test_apply_image_textures_matches_jax(factors, texels):
    rng = np.random.RandomState(4)
    n = 40000
    cls, lx, ly, lz, pwx, pwy, alb = _class_planes(n, rng)
    phase = 0.37
    got, (du, dv, rough, w_nr) = textures.apply_image_textures(
        tuple(map(T, alb)), T(lx), T(ly), T(lz), T(pwx), T(pwy), T(cls), texels, T(phase))
    want, (jdu, jdv, jrough, jw) = jtx.apply_image_textures(
        tuple(map(jnp.asarray, alb)), lx, ly, lz, pwx, pwy, cls, factors[1],
        tex_phase=jnp.float32(phase), with_nr=True)
    np.testing.assert_array_equal(w_nr.numpy(), np.asarray(jw))
    values = list(zip(got, want)) + [(du, jdu), (dv, jdv)]
    mapped = w_nr.numpy() > 0  # roughness is read only where a map applies
    off = [np.abs(a.numpy() - np.asarray(b)) > 1e-6 for a, b in values]
    off.append((np.abs(rough.numpy() - np.asarray(jrough)) > 1e-6) & mapped)
    share = np.mean(off)
    assert share <= 1e-4, share
    # Every class band was exercised, mapped and not.
    assert mapped.any() and (~mapped).any()
    assert (np.abs(got[0].numpy() - alb[0]) > 1e-3).mean() > 0.2


def test_perturb_normal_matches_jax():
    rng = np.random.RandomState(5)
    n = 5000
    v = rng.normal(size=(3, n)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0)
    v[:, :50] = np.array([[0.0], [0.0], [1.0]], np.float32)  # vertical: the +x fallback
    du = rng.uniform(-1, 1, n).astype(np.float32)
    dv = rng.uniform(-1, 1, n).astype(np.float32)
    du[100:200] = dv[100:200] = 0.0
    got = sh.perturb_normal(tuple(map(T, v)), T(du), T(dv))
    want = jsh.perturb_normal(tuple(map(jnp.asarray, v)), jnp.asarray(du), jnp.asarray(dv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sum(a.numpy() ** 2 for a in got), 1.0, atol=1e-5)


def test_shade_with_roughness_matches_jax():
    rng = np.random.RandomState(6)
    hh, ww = 16, 24
    t = np.where(rng.rand(hh, ww) < 0.2, np.inf, 5.0).astype(np.float32)
    nrm = rng.normal(size=(3, hh, ww)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    rd = rng.normal(size=(3, hh, ww)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0)
    pos = tuple(rng.uniform(-3, 3, (hh, ww)).astype(np.float32) for _ in range(3))
    alb = tuple(rng.uniform(0, 1, (hh, ww)).astype(np.float32) for _ in range(3))
    ao = rng.uniform(0.45, 1.0, (hh, ww)).astype(np.float32)
    rough = rng.uniform(0, 1, (hh, ww)).astype(np.float32)
    spec_w = np.where(rng.rand(hh, ww) < 0.5, 0.0, rng.uniform(0, 1, (hh, ww))).astype(np.float32)
    jl0 = jsh.default_lighting()._replace(tex_strength=jnp.float32(0.0))
    want = jsh.shade(t, tuple(nrm), pos, tuple(rd), alb, jl0, ao=ao, rough=rough, spec_w=spec_w)
    lit = convert.lighting(jl0, batched=False)
    b = lambda a: T(a)[None]
    got = sh.shade(b(t), tuple(map(b, nrm)), tuple(map(b, pos)), tuple(map(b, rd)),
                   tuple(map(b, alb)), lit, ao=b(ao), rough=b(rough), spec_w=b(spec_w))
    for a, r in zip(got, want):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(r), rtol=0, atol=1e-5)


def test_shade_zero_spec_weight_is_bit_identical():
    """Weight 0 adds an exact 0: the pixels equal the untextured shade bit
    for bit, as the JAX test of the same name holds."""
    n = 128
    gen = torch.Generator().manual_seed(0)
    t = (torch.abs(torch.randn(1, n, generator=gen)) * 10 + 1)
    nrm = (torch.full((1, n), 0.1), torch.full((1, n), 0.2),
           torch.full((1, n), float(np.sqrt(np.float32(1 - 0.01 - 0.04)))))
    pos = (torch.zeros(1, n), torch.zeros(1, n), torch.ones(1, n))
    ray = (torch.full((1, n), 0.6), torch.zeros(1, n), torch.full((1, n), -0.8))
    alb = (torch.full((1, n), 0.5), torch.full((1, n), 0.4), torch.full((1, n), 0.3))
    lit = sh.default_lighting()
    base = sh.shade(t, nrm, pos, ray, alb, lit)
    spec0 = sh.shade(t, nrm, pos, ray, alb, lit, rough=torch.full((1, n), 0.7),
                     spec_w=torch.zeros(1, n))
    for a, b in zip(base, spec0):
        assert torch.equal(a, b)
    spec1 = sh.shade(t, nrm, pos, ray, alb, lit, rough=torch.full((1, n), 0.3),
                     spec_w=torch.ones(1, n))
    assert float((spec1[0] - base[0]).max()) > 1e-4


@pytest.fixture(scope="module")
def renders(factors, texels):
    """Two sampled scenes rendered by JAX's textured jnp tier and by the
    port's textured plain path, with the hash noise off, and the port's
    untextured render of the same inputs."""
    jroster = jworld.make_roster(JCFG.scene)
    jcaster = jrc.make_raycaster(jroster, scene_cfg=JCFG.scene)
    jintr = jcam.intrinsics_from_apertures(12.0, 25.0, W, H)
    keys = jax.random.split(jax.random.PRNGKey(31), 2)
    poses = jax.jit(jax.vmap(lambda k: jpl.randomize_scene(
        k, jroster, JCFG.scene, JCFG.randomization, articulate_crane=True)[0]))(keys)
    lits = jax.vmap(jlit.sample_lighting)(jax.random.split(jax.random.PRNGKey(32), 2))
    lits = lits._replace(tex_strength=jnp.zeros(2, jnp.float32))
    # Close views of the worker (frame 0) and of the worker and the dumper
    # (frame 1), with ground, trees and sky behind.
    cam = np.array([[2.5, -4.0, 1.7], [13.0, 3.0, 3.0]], np.float32)
    tgt = np.array([[6.9, -1.8, 1.0], [7.6, 2.5, 0.8]], np.float32)

    def one(pose, c, t, lit):
        w = jworld.build_world(jroster, pose)
        return jann.render_frame(jroster, jcaster, w, c, t, jintr, lighting=lit,
                                 texture_factors=factors[1])

    ref = jax.jit(jax.vmap(one))(poses, cam, tgt, lits)
    roster = world.make_roster(SceneConfig())
    intr = camera.intrinsics_from_apertures(12.0, 25.0, W, H)
    caster = raycast.Raycaster(roster)
    sweeper = sweep_kernel.PixelSweeper(roster, intr, caster)
    wt = world.build_world(roster, convert.scene_pose(poses))
    args = (roster, caster, sweeper, wt, T(cam), T(tgt), intr, convert.lighting(lits))
    return dict(ref=ref, mine=annotate.render_frame(*args, texels=texels),
                plain=annotate.render_frame(*args), roster=roster)


def test_textured_plain_rgb_matches_jax_textured_tier(renders):
    ref, mine = renders["ref"], renders["mine"]
    np.testing.assert_array_equal(mine.instance.numpy(), np.asarray(ref.instance))
    a, b = mine.rgb.numpy().astype(np.int32), np.asarray(ref.rgb, np.int32)
    d = np.abs(a - b)
    sky = np.broadcast_to((np.asarray(ref.instance) == -2)[..., None], a.shape)
    assert d.mean() < 0.5, d.mean()
    assert (d > 1).mean() < 0.02, (d > 1).mean()
    assert sky.any() and (a[sky] == b[sky]).all()


def test_textured_render_changes_rgb_only(renders):
    """The tier is RGB-only: depth, instance, boxes and keypoints equal the
    untextured render's; mapped classes change, cones, fences and the sky
    do not."""
    mine, plain, roster = renders["mine"], renders["plain"], renders["roster"]
    for f in ("depth", "instance", "bbox2d", "kpt_uv", "kpt_visible", "center", "euler_deg"):
        assert torch.equal(getattr(mine, f), getattr(plain, f)), f
    changed = (torch.abs(mine.rgb.float() - plain.rgb.float()).amax(-1) > 2).numpy()
    inst = plain.instance.numpy()
    names = roster.inst_class_names
    classes = {"ground" if i == -1 else "sky" if i == -2 else names[i]
               for i in np.unique(inst[changed])}
    assert changed.any() and "sky" not in classes
    assert {"ground", "tree", "human"} <= classes, classes
    for i in np.unique(inst):
        if i >= 0 and names[i] in ("trafficcone", "fence"):
            assert not changed[inst == i].any(), names[i]


def test_fused_rgb_textured_dispatches_plain_on_cpu(renders, texels):
    """On CPU tensors the wrapper takes the plain version and counts no
    launch; the kernel refuses CPU tensors."""
    b = (rgb_kernel.rgb_cuda.launches, rgb_kernel.rgb_cuda.textured_launches)
    t = torch.full((1, 8, 32), float("inf"))
    inst = torch.full((1, 8, 32), -2, dtype=torch.int32)
    roster = renders["roster"]
    table = rgb_kernel.instance_table(roster, torch.eye(3).expand(1, roster.num_instances, 3, 3),
                                      torch.zeros(1, roster.num_instances, 3))
    ao = torch.zeros(1, 1, 4)
    par = torch.zeros(1, rgb_kernel.N_PAR)
    par[0, 0] = par[0, 4] = par[0, 8] = par[0, 11] = par[0, 12] = 1.0
    out = rgb_kernel.fused_rgb(t, inst, table, ao, par, texels)
    assert torch.equal(out, rgb_kernel.plain_rgb(t, inst, table, ao, par, texels))
    assert (rgb_kernel.rgb_cuda.launches, rgb_kernel.rgb_cuda.textured_launches) == b
    with pytest.raises(ValueError, match="CUDA"):
        rgb_kernel.rgb_cuda(t, inst, table, ao, par, texels)
    with pytest.raises(ValueError, match="meta"):
        rgb_kernel.fused_rgb(t.to("meta"), inst, table, ao, par, texels)


@pytest.mark.parametrize("hifi", [False, True])
def test_pipeline_image_textures_compose(hifi):
    """``Pipeline(image_textures=True)``, alone and with the hifi tier: the
    labels are the untextured pipeline's, the RGB is textured, and the
    texel table stays on the host until the first batch."""
    cfg = Config(pipeline=PipelineConfig(render_width=64, render_height=48, batch_size=2))
    tex = Pipeline(cfg, device="cpu", hifi_mesh=hifi, image_textures=True)
    assert tex._texels.shape == (13, 128, 128, 4)
    plain = Pipeline(cfg, device="cpu", hifi_mesh=hifi)
    ids = range(3, 5) if hifi else range(2)
    a = tex.make_generate_fn()(5, ids)
    b = plain.make_generate_fn()(5, ids)
    for f in a._fields:
        if f != "rgb":
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.rgb, b.rgb) and a.rgb.float().std() > 5.0
    seq = tex.make_sequence_fn(3)(5, range(2))
    assert not torch.equal(seq.rgb, plain.make_sequence_fn(3)(5, range(2)).rgb)
