"""The port's last RGB tiers against the JAX package's: the exact caster
(``Raycaster.cast``, JAX ``make_raycaster``'s ``cast``) and its analytic
normals, the per-origin packed sweep of the sun-shadow rays
(``fast_multi_origin``), the hifi caster's unfiltered ``cast`` and shadow
sweep, ``shade``'s ``shadow_t``, the plain RGB version with a given
normal, a shadow plane and the flat albedo, ``render_frame`` with
``analytic_normals``, ``sun_shadows`` and ``procedural_textures=False``
(alone, together, with and without image textures) and
``Pipeline(procedural_textures=False)``.

Tolerances. The exact sweep is f32 on both sides in the same formulas:
hit masks, winning primitive and instance exact; t to 1e-5 relative but
on grazing quadric rays (a discriminant near 0, where f32 rounding in
either package moves t by up to ~5e-5: at most 0.5% of the hits, and all
within 2e-4, the tolerances of tests/test_sweep_kernel.py); the normal of
each primitive kind to 1e-5 on the same hit point, and the cast's normals
to 1e-5 on all but 2% of the hits (the grazing ones, where a t that moves
by 1e-5 tilts the normal of a thin capsule or cylinder by ~1e-3), within
1e-2 on all. The packed per-origin sweep: hit masks and instances equal, t
within one step of the 6-bit packing (2^-17 relative) on all but the
grazing 0.5%, all within 2e-4. Rendered
RGB, the tolerances of tests/test_torch_rgb.py: hash noise off, mean |d| <
0.5 u8 and |d| > 1 on < 2% of the values, sky exact; noise on, means within
1.0 and standard deviations within 2.0. Labels: those of
tests/test_torch_pipeline.py against JAX, and bit-equal to the port's own
default render where the tier is RGB-only (JAX's
``test_procedural_textures_affect_rgb_only``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.ops import heatmap as jhm
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
from constructionsceneposeestimation_tpu_torch.render import (annotate, meshcast, raycast,
                                                              rgb_kernel, shading as sh,
                                                              sweep_kernel, textures)
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
JCFG = JConfig()
W, H = 64, 48
T = lambda a: torch.as_tensor(np.array(a, np.float32))
LABELS = ("depth", "instance", "bbox2d", "kpt_uv", "kpt_visible", "center", "euler_deg",
          "inst_pixel_count", "pointcloud_count")
# (analytic_normals, sun_shadows, procedural_textures, textured): each tier,
# two and three together, and the textured combinations.
TIERS = {
    "analytic": (True, False, True, False),
    "shadows": (False, True, True, False),
    "flat": (False, False, False, False),
    "analytic+shadows": (True, True, True, False),
    "all": (True, True, False, False),
    "textured analytic+shadows": (True, True, True, True),
    "textured flat": (False, False, False, True),
}
# The textured flat render reads no texels (test_flat_tier_drops_image_textures):
# JAX's is its flat render.
SAME_AS = {"textured flat": "flat"}


@pytest.fixture(scope="module")
def scene():
    """Two sampled scenes, both packages' worlds and casters, and random
    rays from two origins toward the yard."""
    jroster = jworld.make_roster(JCFG.scene)
    jcaster = jrc.make_raycaster(jroster, scene_cfg=JCFG.scene)
    keys = jax.random.split(jax.random.PRNGKey(41), 2)
    poses = jax.jit(jax.vmap(lambda k: jpl.randomize_scene(
        k, jroster, JCFG.scene, JCFG.randomization, articulate_crane=True)[0]))(keys)
    roster = world.make_roster(SceneConfig())
    wt = world.build_world(roster, convert.scene_pose(poses))
    return dict(jroster=jroster, jcaster=jcaster, poses=poses, roster=roster, world=wt,
                caster=raycast.Raycaster(roster))


def _random_rays(seed, n=3000):
    rng = np.random.RandomState(seed)
    o = np.stack([rng.uniform(-12, 12, 2), rng.uniform(-12, 12, 2),
                  rng.uniform(0.5, 4.0, 2)], -1).astype(np.float32)
    tgt = np.stack([rng.uniform(-10, 10, (2, n)), rng.uniform(-10, 10, (2, n)),
                    rng.uniform(0.0, 3.0, (2, n))], -1).astype(np.float32)
    d = tgt - o[:, None]
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _jax_vmapped(scene, fn):
    def one(pose, *args):
        return fn(jworld.build_world(scene["jroster"], pose), *args)
    return jax.jit(jax.vmap(one))


def _rel(a, b):
    fin = np.isfinite(b)
    return np.abs(a[fin] - b[fin]) / np.abs(b[fin])


def test_cast_matches_jax(scene):
    o, d = _random_rays(0)
    mine = scene["caster"].cast(scene["world"], T(o), T(d))
    ref = _jax_vmapped(scene, lambda w, oo, dd: scene["jcaster"](w, oo, dd))(scene["poses"], o, d)
    t, rt = mine["t"].numpy(), np.asarray(ref["t"])
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(rt))
    np.testing.assert_array_equal(mine["prim"].numpy(), np.asarray(ref["prim"]))
    np.testing.assert_array_equal(mine["inst"].numpy(), np.asarray(ref["inst"]))
    hit = np.isfinite(rt)
    assert 0.5 < hit.mean() < 1.0  # some rays miss
    rel = _rel(t, rt)
    assert rel.max() < 2e-4 and (rel > 1e-5).mean() < 0.005, (rel.max(), (rel > 1e-5).mean())
    dn = np.abs(mine["normal"].numpy() - np.asarray(ref["normal"])).max(-1)
    assert (dn[hit] > 1e-5).mean() < 0.02 and dn.max() < 1e-2, ((dn[hit] > 1e-5).mean(), dn.max())
    assert not mine["normal"].numpy()[~hit].any()
    np.testing.assert_allclose(np.linalg.norm(mine["normal"].numpy()[hit], axis=-1), 1.0,
                               atol=1e-5)
    # Every primitive kind was hit.
    kinds = np.asarray(scene["roster"].prim_kind)[mine["prim"].numpy()[hit]]
    assert set(np.unique(kinds)) == set(np.unique(scene["roster"].prim_kind))


def test_local_normal_matches_jax_on_the_same_hits(scene):
    """The normal formulas alone: JAX's ``_local_normal`` and the port's on
    the same (kind, local ray, t, params) of every kind, including hits on
    box faces, cylinder and cone caps and capsule balls."""
    rng = np.random.RandomState(1)
    n = 6000
    params = rng.uniform(0.1, 1.5, (n, 4)).astype(np.float32)
    kind = rng.randint(0, 6, n)
    ol = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    dl = rng.normal(size=(n, 3)).astype(np.float32)
    dl /= np.linalg.norm(dl, axis=-1, keepdims=True)
    t = rng.uniform(0.5, 6, n).astype(np.float32)
    # Points on caps and faces: z = +-h, and on a box's face.
    p = ol + t[:, None] * dl
    cap = rng.rand(n) < 0.3
    ol[cap, 2] = (np.sign(p[cap, 2]) * params[cap, 2] - t[cap] * dl[cap, 2]).astype(np.float32)
    mine = raycast._local_normal(torch.as_tensor(kind), T(ol), T(dl), T(t), T(params))
    ref = jrc._local_normal(jnp.asarray(kind), ol, dl, t, params)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_fast_multi_origin_matches_jax(scene):
    o, d = _random_rays(2)
    rng = np.random.RandomState(3)
    ro = (o[:, None] + rng.uniform(-4, 4, d.shape)).astype(np.float32)
    ro[..., 2] = np.abs(ro[..., 2])
    mine = scene["caster"].fast_multi_origin(scene["world"], T(ro), T(d))
    ref = _jax_vmapped(scene, lambda w, oo, dd: scene["jcaster"].fast_multi_origin(w, oo, dd))(
        scene["poses"], ro, d)
    t, rt = mine["t"].numpy(), np.asarray(ref["t"])
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(rt))
    np.testing.assert_array_equal(mine["inst"].numpy(), np.asarray(ref["inst"]))
    rel = _rel(t, rt)
    assert rel.max() < 2e-4 and (rel > 2.0 ** -17).mean() < 0.005, (rel.max(),
                                                                    (rel > 2.0 ** -17).mean())
    # The packed t is the exact sweep's to the 6-bit payload.
    exact = scene["caster"].cast
    for f in range(2):
        for i in range(0, d.shape[1], 500):
            e = exact({k: v[f:f + 1] if v.dim() > 2 else v for k, v in scene["world"].items()},
                      T(ro[f, i]).reshape(1, 3), T(d[f, i]).reshape(1, 1, 3))
            if np.isfinite(t[f, i]):
                assert abs(t[f, i] - e["t"].item()) <= 2.0 ** -17 * e["t"].item()


def test_exact_and_packed_casts_agree(scene):
    """``cast`` and ``fast`` on the same shared-origin rays: the same hits
    and instances, t within the packing."""
    o, d = _random_rays(4)
    c = scene["caster"]
    e, f = c.cast(scene["world"], T(o), T(d)), c.fast(scene["world"], T(o), T(d))
    assert (torch.isfinite(e["t"]) == torch.isfinite(f["t"])).float().mean() > 0.999
    both = torch.isfinite(e["t"]) & torch.isfinite(f["t"])
    assert (e["inst"][both] == f["inst"][both]).float().mean() > 0.999
    rel = (torch.abs(e["t"] - f["t"]) / e["t"])[both]
    assert (rel > 1e-5).float().mean() < 0.005 and rel.max() < 2e-4


def test_hifi_caster_casts_are_the_full_proxy_rosters(scene):
    """The hifi caster's exact caster and shadow sweep are the unfiltered
    proxy roster's, as JAX's ``make_hifi_caster`` keeps them."""
    roster, w = scene["roster"], scene["world"]
    hifi = meshcast.HifiCaster(roster, grid_hw=(H, W))
    o, d = _random_rays(5, 1500)
    full = scene["caster"]
    a, b = hifi.cast(w, T(o), T(d)), full.cast(w, T(o), T(d))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    base = hifi.base.cast(w, T(o), T(d))
    covered = torch.as_tensor(hifi.mesh.covered_prims)[torch.clamp_min(b["prim"], 0)]
    assert bool((covered & (b["prim"] >= 0)).any())
    assert not torch.equal(base["prim"], b["prim"])
    ro = T(o)[:, None, :] + T(d) * 3.0
    sa = hifi.fast_multi_origin(w, ro, T(d))
    sb = full.fast_multi_origin(w, ro, T(d))
    assert torch.equal(sa["t"], sb["t"]) and torch.equal(sa["inst"], sb["inst"])


def test_shade_with_shadow_matches_jax():
    rng = np.random.RandomState(6)
    hh, ww = 16, 24
    t = np.where(rng.rand(hh, ww) < 0.2, np.inf, 5.0).astype(np.float32)
    nrm = rng.normal(size=(3, hh, ww)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    rd = rng.normal(size=(3, hh, ww)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0)
    pos = tuple(rng.uniform(-3, 3, (hh, ww)).astype(np.float32) for _ in range(3))
    alb = tuple(rng.uniform(0, 1, (hh, ww)).astype(np.float32) for _ in range(3))
    shadow = np.where(rng.rand(hh, ww) < 0.5, np.inf, rng.uniform(0.1, 30, (hh, ww)))
    shadow = shadow.astype(np.float32)
    rough = rng.uniform(0, 1, (hh, ww)).astype(np.float32)
    spec_w = rng.uniform(0, 1, (hh, ww)).astype(np.float32)
    jl0 = jsh.default_lighting()._replace(tex_strength=jnp.float32(0.0))
    lit = convert.lighting(jl0, batched=False)
    b = lambda a: T(a)[None]
    for extra in ({}, {"rough": rough, "spec_w": spec_w}):
        want = jsh.shade(t, tuple(nrm), pos, tuple(rd), alb, jl0, shadow_t=shadow, **extra)
        got = sh.shade(b(t), tuple(map(b, nrm)), tuple(map(b, pos)), tuple(map(b, rd)),
                       tuple(map(b, alb)), lit, shadow_t=b(shadow),
                       **{k: b(v) for k, v in extra.items()})
        for a, r in zip(got, want):
            np.testing.assert_allclose(a[0].numpy(), np.asarray(r), rtol=0, atol=1e-5)
    # Lit pixels are bit-equal to the shade without shadows; shadowed ones
    # lose the sun.
    base = sh.shade(b(t), tuple(map(b, nrm)), tuple(map(b, pos)), tuple(map(b, rd)),
                    tuple(map(b, alb)), lit)
    shadowed = sh.shade(b(t), tuple(map(b, nrm)), tuple(map(b, pos)), tuple(map(b, rd)),
                        tuple(map(b, alb)), lit, shadow_t=b(shadow))
    lit_px = torch.as_tensor(shadow >= 1e9)[None] | ~torch.isfinite(b(t))
    for x, y in zip(base, shadowed):
        assert torch.equal(x[lit_px], y[lit_px]) and bool((y <= x).all())


@pytest.fixture(scope="module")
def renders(scene):
    """Both packages' renders of the two scenes in each tier of ``TIERS``,
    hash noise off, at 64 x 48, and the port's default render."""
    jroster, jcaster, poses = scene["jroster"], scene["jcaster"], scene["poses"]
    jintr = jcam.intrinsics_from_apertures(12.0, 25.0, W, H)
    jfac = jtx.load_factors()
    lits = jax.vmap(jlit.sample_lighting)(jax.random.split(jax.random.PRNGKey(42), 2))
    lits = lits._replace(tex_strength=jnp.zeros(2, jnp.float32),
                         sun_dir=jnp.asarray([[0.45, 0.3, -0.84], [-0.6, 0.2, -0.77]],
                                             jnp.float32))
    lits = lits._replace(sun_dir=lits.sun_dir / jnp.linalg.norm(lits.sun_dir, axis=-1,
                                                                keepdims=True))
    # Close views of the worker and the dumper (frame 0) and of the yard
    # from the fence (frame 1): ground, trees, cones, the crane and sky.
    cam = np.array([[2.5, -4.0, 1.7], [-14.0, 8.0, 6.0]], np.float32)
    tgt = np.array([[6.9, -1.8, 1.0], [2.0, 0.0, 1.0]], np.float32)
    roster, wt = scene["roster"], scene["world"]
    intr = camera.intrinsics_from_apertures(12.0, 25.0, W, H)
    caster = scene["caster"]
    sweeper = sweep_kernel.PixelSweeper(roster, intr, caster)
    texels = textures.dense_table(textures.load_factors())
    args = (roster, caster, sweeper, wt, T(cam), T(tgt), intr, convert.lighting(lits))
    out = {"default": annotate.render_frame(*args)}
    ref, jfn = {}, {}
    for name, (an, ss, pt, tex) in TIERS.items():
        def one(pose, c, t, lit, an=an, ss=ss, pt=pt, tex=tex):
            w = jworld.build_world(jroster, pose)
            return jann.render_frame(jroster, jcaster, w, c, t, jintr, lighting=lit,
                                     analytic_normals=an, sun_shadows=ss,
                                     procedural_textures=pt,
                                     texture_factors=jfac if tex else None)
        if name in SAME_AS:
            ref[name] = ref[SAME_AS[name]]
        else:
            jfn[name] = jax.jit(jax.vmap(one))
            ref[name] = jfn[name](poses, cam, tgt, lits)
        out[name] = annotate.render_frame(*args, texels=texels if tex else None,
                                          analytic_normals=an, sun_shadows=ss,
                                          procedural_textures=pt)
    return dict(ref=ref, mine=out, jfn=jfn, args=args, texels=texels, lits=lits, cam=cam,
                tgt=tgt, jintr=jintr)


def _rgb_agree(a, b, inst):
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    d = np.abs(a - b)
    sky = np.broadcast_to((np.asarray(inst) == -2)[..., None], a.shape)
    assert d.mean() < 0.5, d.mean()
    assert (d > 1).mean() < 0.02, (d > 1).mean()
    assert sky.any() and (a[sky] == b[sky]).all()


def _labels_agree(mine, ref):
    dm, dr = mine.depth.numpy(), np.asarray(ref.depth)
    assert (np.isfinite(dm) == np.isfinite(dr)).mean() > 0.999
    fin = np.isfinite(dm) & np.isfinite(dr)
    np.testing.assert_allclose(dm[fin], dr[fin], rtol=3e-4)
    assert (mine.instance.numpy() == np.asarray(ref.instance)).mean() > 0.999
    # Keypoints far off the frame project to |uv| ~ 1e3 px: 1e-5 relative.
    for f, tol in (("center", 1e-4), ("size", 1e-4), ("euler_deg", 1e-2), ("kpt_uv", 1e-3)):
        np.testing.assert_allclose(getattr(mine, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=tol, rtol=1e-5, err_msg=f)
    assert (mine.kpt_visible.numpy() == np.asarray(ref.kpt_visible)).mean() >= 0.99


@pytest.mark.parametrize("tier", list(TIERS))
def test_render_frame_tier_matches_jax(renders, tier):
    mine, ref = renders["mine"][tier], renders["ref"][tier]
    _labels_agree(mine, ref)
    _rgb_agree(mine.rgb.numpy(), ref.rgb, ref.instance)


@pytest.mark.parametrize("tier", list(TIERS))
def test_render_frame_tier_changes_what_jax_changes(renders, tier):
    """Each tier changes the RGB; the RGB-only tiers leave every label
    bit-equal to the default render; ``analytic_normals`` moves depth by at
    most the packing and keeps the instance map."""
    mine, default = renders["mine"][tier], renders["mine"]["default"]
    assert (torch.abs(mine.rgb.float() - default.rgb.float()) > 2).float().mean() > 0.01
    analytic = TIERS[tier][0]
    for f in LABELS:
        a, b = getattr(mine, f), getattr(default, f)
        if not analytic:
            assert torch.equal(a, b), f
    if analytic:
        assert (mine.instance == default.instance).float().mean() > 0.999
        both = torch.isfinite(mine.depth) & torch.isfinite(default.depth)
        rel = (torch.abs(mine.depth - default.depth) / mine.depth)[both]
        assert (rel > 1e-5).float().mean() < 0.005 and rel.max() < 2e-4


def test_flat_tier_drops_image_textures(renders):
    """With ``procedural_textures=False`` the texels are not read, as JAX's
    texture block sits inside its procedural branch: the textured flat
    render equals the flat one."""
    assert torch.equal(renders["mine"]["textured flat"].rgb, renders["mine"]["flat"].rgb)


def test_sun_shadows_darken_only_shadowed_pixels(renders):
    """The shadow tier equals the default render on the pixels its shadow
    rays see lit, and is darker on a share of the hit pixels."""
    roster, caster, _, w, cam, tgt, intr, lit = renders["args"]
    mine, default = renders["mine"]["shadows"], renders["mine"]["default"]
    M = camera.look_at_matrix(cam, tgt)
    rd = camera.pixel_rays(intr, M)
    hit = torch.isfinite(default.depth)
    t = torch.where(hit, default.depth / torch.sum(rd * (-M[:, :, 0])[:, None, None], -1), 0.0)
    sun = -lit.sun_dir
    origins = cam[:, None, None, :] + t[..., None] * rd + (sun * 1e-3)[:, None, None, :]
    st = caster.fast_multi_origin(w, origins.reshape(2, -1, 3),
                                  sun[:, None].expand(2, H * W, 3))["t"].reshape(2, H, W)
    # Hit points recomputed from depth move by an ulp: compare away from
    # the shadow's edge, where the two shadow rays agree.
    shadowed = (st < 1e9) & hit
    assert 0.02 < shadowed.float().mean() < 0.9
    changed = (mine.rgb != default.rgb).any(-1)
    assert not bool((changed & ~shadowed).any())
    assert bool((mine.rgb.float().sum(-1) <= default.rgb.float().sum(-1) + 3).all())


def test_plain_rgb_tiers_match_jnp_tier_on_jax_hits(scene, renders):
    """The plain version fed JAX's own exact hits, normals and shadow
    distances against JAX's ``jnp`` tier, hash noise off and on: the
    shading alone, with the casters taken out."""
    jroster, jcaster = scene["jroster"], scene["jcaster"]
    jintr = renders["jintr"]
    roster, _, _, w, cam, tgt, intr, _ = renders["args"]

    def hits(pose, c, t, lit):
        wj = jworld.build_world(jroster, pose)
        M = jcam.look_at_matrix(c, t)
        origin, dirs = jcam.pixel_rays(jintr, c, M)
        rd = dirs.reshape(-1, 3)
        h = jcaster(wj, origin, rd)
        depth = jnp.where(jnp.isfinite(h["t"]), h["t"] * (rd @ -M[:, 0]), jnp.inf)
        clipped = depth >= 250.0
        tt = jnp.where(clipped, jnp.inf, h["t"])
        ts = jnp.where(jnp.isfinite(tt), tt, 0.0)
        p = origin[None, :] + ts[:, None] * rd
        s = -lit.sun_dir
        sh_t = jcaster.fast_multi_origin(wj, p + s[None, :] * 1e-3,
                                         jnp.broadcast_to(s, p.shape))["t"]
        return tt, jnp.where(clipped, -2, h["inst"]), h["normal"], sh_t

    hits_fn = jax.jit(jax.vmap(hits))
    jrender = renders["jfn"]["analytic+shadows"]
    M = camera.look_at_matrix(T(renders["cam"]), T(renders["tgt"]))
    for noise in (False, True):
        jl = renders["lits"]
        if noise:
            jl = jl._replace(tex_strength=jnp.ones(2, jnp.float32))
        tt, inst, nrm, sh_t = (np.asarray(x) for x in hits_fn(scene["poses"], renders["cam"],
                                                            renders["tgt"], jl))
        lit = convert.lighting(jl)
        par = rgb_kernel.rgb_params(M, T(renders["cam"]), intr, lit)
        args = (T(tt).reshape(2, H, W),
                torch.as_tensor(np.array(inst)).reshape(2, H, W).to(torch.int32),
                rgb_kernel.instance_table(roster, w["inst_rot"], w["inst_pos"]),
                rgb_kernel.ao_table(roster, w["inst_pos"]), par)
        mine = rgb_kernel.plain_rgb(*args, normal=T(nrm).reshape(2, H, W, 3),
                                    shadow_t=T(sh_t).reshape(2, H, W))
        ref = jrender(scene["poses"], renders["cam"], renders["tgt"], jl)
        if noise:
            a, b = mine.numpy().astype(np.float32), np.asarray(ref.rgb, np.float32)
            assert abs(a.mean() - b.mean()) < 1.0 and abs(a.std() - b.std()) < 2.0
        else:
            _rgb_agree(mine.numpy(), ref.rgb, ref.instance)


def test_fused_rgb_tiers_dispatch_plain_on_cpu(renders):
    """On CPU tensors every tier takes the plain version and counts no
    launch; the kernel refuses CPU tensors."""
    counts = (rgb_kernel.rgb_cuda.launches, rgb_kernel.rgb_cuda.textured_launches,
              dict(rgb_kernel.rgb_cuda.tier_launches))
    B_, hh, ww = 1, 8, 32
    t = torch.full((B_, hh, ww), 4.0)
    inst = torch.full((B_, hh, ww), -1, dtype=torch.int32)
    roster = renders["args"][0]
    table = rgb_kernel.instance_table(roster, torch.eye(3).expand(1, roster.num_instances, 3, 3),
                                      torch.zeros(1, roster.num_instances, 3))
    ao = torch.zeros(1, 1, 4)
    par = torch.zeros(1, rgb_kernel.N_PAR)
    par[0, 0] = par[0, 4] = par[0, 8] = par[0, 11] = par[0, 12] = par[0, 19] = 1.0
    par[0, 18] = -1.0
    nrm = torch.zeros(B_, hh, ww, 3)
    nrm[..., 2] = 1.0
    shadow = torch.zeros(B_, hh, ww)
    kw = dict(normal=nrm, shadow_t=shadow, procedural=False)
    out = rgb_kernel.fused_rgb(t, inst, table, ao, par, renders["texels"], **kw)
    assert torch.equal(out, rgb_kernel.plain_rgb(t, inst, table, ao, par, **kw))
    assert torch.equal(rgb_kernel.fused_rgb(t, inst, table, ao, par, shadow_t=shadow * 0 + 1e10),
                       rgb_kernel.fused_rgb(t, inst, table, ao, par))
    assert (rgb_kernel.rgb_cuda.launches, rgb_kernel.rgb_cuda.textured_launches,
            rgb_kernel.rgb_cuda.tier_launches) == counts
    with pytest.raises(ValueError, match="CUDA"):
        rgb_kernel.rgb_cuda(t, inst, table, ao, par, **kw)
    with pytest.raises(ValueError, match="meta"):
        rgb_kernel.fused_rgb(t.to("meta"), inst, table, ao, par, **kw)


def test_variant_names():
    assert rgb_kernel.variant_name(False, 0) == "default"
    assert rgb_kernel.variant_name(True, 0) == "textured"
    assert rgb_kernel.variant_name(False, rgb_kernel.tier_mask(shadow_t=1, procedural=False)) \
        == "flat+shadow"
    assert len(rgb_kernel.VARIANTS) == 10 and "textured+normal+shadow" in rgb_kernel.VARIANTS
    assert all("textured" not in v for v in rgb_kernel.VARIANTS if "flat" in v)


def test_pipeline_procedural_textures_false_matches_jax():
    """``Pipeline(procedural_textures=False)``'s generate against the JAX
    per-frame body with ``procedural_textures=False`` on the very scenes,
    cameras and lights the port sampled; labels equal to the default
    pipeline's, RGB flat."""
    cfg = Config(pipeline=PipelineConfig(render_width=W, render_height=H, batch_size=2))
    flat = Pipeline(cfg, device="cpu", procedural_textures=False)
    assert Pipeline(cfg, device="cpu").procedural_textures
    fids = [3, 4]
    batch = flat.make_generate_fn()(9, fids)
    default = Pipeline(cfg, device="cpu").make_generate_fn()(9, fids)
    for f in batch._fields:
        if f != "rgb":
            assert torch.equal(getattr(batch, f), getattr(default, f)), f
    assert not torch.equal(batch.rgb, default.rgb)
    inputs = flat.sample_inputs(9, fids)
    jroster = jworld.make_roster(JCFG.scene)
    jcaster = jrc.make_raycaster(jroster, scene_cfg=JCFG.scene)
    jintr = jcam.intrinsics_from_apertures(12.0, 25.0, W, H)
    ch = jnp.asarray(jroster.inst_kpt_channel)

    def one(pose, c, t, lit):
        ann = jann.render_frame(jroster, jcaster, jworld.build_world(jroster, pose), c, t, jintr,
                                lighting=lit, procedural_textures=False,
                                far_clip=JCFG.camera.clipping[1])
        return ann, jhm.frame_heatmaps(ann.kpt_uv, ann.kpt_visible, ch, 71, H // 4, W // 4,
                                       JCFG.pipeline.heatmap_sigma,
                                       JCFG.pipeline.heatmap_stride)

    pose = jworld.ScenePose(*(None if f is None else jnp.asarray(f.numpy())
                              for f in inputs.pose))
    lit = jsh.Lighting(*(jnp.asarray(f.numpy()) for f in inputs.lighting))
    ref, hms = jax.jit(jax.vmap(one))(pose, jnp.asarray(inputs.cam_pos.numpy()),
                                      jnp.asarray(inputs.target.numpy()), lit)
    _labels_agree(batch, ref)
    np.testing.assert_allclose(batch.heatmaps.numpy(), np.asarray(hms), atol=2e-4)
    a, b = batch.rgb.numpy().astype(np.float32), np.asarray(ref.rgb, np.float32)
    assert abs(a.mean() - b.mean()) < 1.0 and abs(a.std() - b.std()) < 2.0
