"""The textured RGB kernel's mask ladder, mirrored on tensors by
``rgb_kernel.texture_plan_plain``, against the port's plain texturing and
the JAX package's: on 64 x 48 frames of a scene with two dumpers and two
workers, each camera close to a worker, a dumper or a tree, so that every
texture slot is sampled.

Tolerances: none. The plan's bins, sampled and mixed, are the plain
version's ``textures.apply_image_textures`` bit for bit (the same f32
operations in the same order), and its map weight is JAX's bit for bit (a
choice among constants by masks whose inputs, sqrt and compares, both
packages round alike)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.render import textures as jtx
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.render import (raycast, rgb_kernel,
                                                              shading as sh, textures)
from constructionsceneposeestimation_tpu_torch.scene import world as world_mod

torch.set_num_threads(2)
W, H = 64, 48


@pytest.fixture(scope="module")
def scene():
    """The RGB kernel's inputs on four frames, and the plain path's local
    coordinates, class and procedural albedo of each pixel."""
    cfg = Config(scene=SceneConfig(n_dumpers=2, n_humans=2),
                 pipeline=PipelineConfig(render_width=W, render_height=H, batch_size=4))
    pipe = Pipeline(cfg, device="cpu")
    inputs = pipe.sample_inputs(7, range(4))
    world = world_mod.build_world(pipe.roster, inputs.pose)
    names = pipe.roster.inst_class_names
    first = lambda c, k=0: [i for i, n in enumerate(names) if n == c][k]
    pos = world["inst_pos"]
    # Close views of each worker, a dumper and a tree.
    target = torch.stack([pos[0, first("human")], pos[1, first("human", 1)],
                          pos[2, first("dumper")], pos[3, first("tree")]])
    target = target + torch.tensor([0.0, 0.0, 1.0])
    cam_pos = target + torch.tensor([[3.0, -2.0, 0.7], [-2.5, 2.0, 0.9], [5.0, 4.0, 2.0],
                                     [4.0, -4.0, 1.0]])
    M = cam_mod.look_at_matrix(cam_pos, target)
    # The annotation pass's t and instance: misses and the far clip are sky.
    t, code = raycast._unpack(pipe.sweeper(world, cam_pos, M))
    t = torch.where(t < raycast.INF * 0.99, t, float("inf")).reshape(4, H, W)
    rd = cam_mod.pixel_rays(pipe.intr, M)
    clipped = t * torch.sum(rd * (-M[:, :, 0])[:, None, None, :], -1) >= cfg.camera.clipping[1]
    t = torch.where(clipped, float("inf"), t)
    inst = torch.where(clipped, -2, (code - 2).reshape(4, H, W)).to(torch.int32)
    table = rgb_kernel.instance_table(pipe.roster, world["inst_rot"], world["inst_pos"])
    par = rgb_kernel.rgb_params(M, cam_pos, pipe.intr, inputs.lighting)
    pw = rgb_kernel.hit_points(t, par)[1]
    tab = rgb_kernel.table_rows(inst, table)
    lx, ly, lz = rgb_kernel.local_coords(pw, tab)
    cls = tab[..., 15]
    phase = par[:, 24].reshape(4, 1, 1)
    albedo = sh.procedural_albedo((tab[..., 0], tab[..., 1], tab[..., 2]), lx, ly, lz, cls, phase,
                                  par[:, 26].reshape(4, 1, 1))
    return dict(t=t, inst=inst, table=table, par=par, pw=pw, lx=lx, ly=ly, lz=lz, cls=cls,
                phase=phase, albedo=albedo, ao_args=(pipe.roster, world["inst_pos"]),
                plan=rgb_kernel.texture_plan_plain(t, inst, table, par),
                texels=textures.dense_table(textures.load_factors()))


def test_plan_samples_every_slot_and_only_hits(scene):
    plan, hit = scene["plan"], torch.isfinite(scene["t"])
    mixed = {textures.TEX[k] for k in ("bark", "leaf", "twill", "denim", "ground", "dirt",
                                       "cot_ox")}
    maps = {textures.TEX[k] for k in ("leaf_nr", "denim_nr", "twill_nr", "cot_ox_nr")}
    assert set(plan.slot.unique().tolist()) == mixed | {-1}
    assert set(plan.nr_slot.unique().tolist()) == maps | {-1}
    assert (~hit).any() and (plan.slot[~hit] == -1).all() and (plan.nr_slot[~hit] == -1).all()
    assert (plan.w[~hit] == 0).all() and (plan.w_nr[~hit] == 0).all()
    # A map is read only beside a mix sample (the crown and the garments).
    assert (plan.slot[plan.nr_slot >= 0] >= 0).all()
    assert ((plan.ub >= 0) & (plan.ub < rgb_kernel.TEX_BINS)).all()
    assert ((plan.vb >= 0) & (plan.vb < rgb_kernel.TEX_BINS)).all()


def test_plan_sampled_and_mixed_is_apply_image_textures(scene):
    """Gathering the plan's texels at its bins, tinting and mixing by its
    weights gives ``textures.apply_image_textures``'s albedo, offsets and
    roughness bit for bit."""
    s, plan, texels = scene, scene["plan"], scene["texels"]
    want, (du, dv, rough, w_nr) = textures.apply_image_textures(
        s["albedo"], s["lx"], s["ly"], s["lz"], s["pw"][0], s["pw"][1], s["cls"], texels,
        s["phase"])
    flat = texels.reshape(-1, 4)
    B = rgb_kernel.TEX_BINS
    texel = lambda slot: flat[(slot.clamp_min(0) * B + plan.ub) * B + plan.vb]
    c = texel(plan.slot)
    tint = [torch.where(plan.slot == textures.TEX["denim"], a,
                        torch.where(plan.slot == textures.TEX["cot_ox"], b, 1.0))
            for a, b in zip(textures.LEGS_TINT, textures.SHIRT_TINT)]
    c = [torch.clamp(tc * c[..., i], 0.0, 1.0) for i, tc in enumerate(tint)]
    vest = plan.slot == textures.TEX["twill"]
    weave = 0.6 + 0.8 * c[0]
    for i, (a, wa) in enumerate(zip(s["albedo"], want)):
        got = torch.where(vest, a * weave, a * (1.0 - plan.w) + c[i] * plan.w)
        got = torch.where(plan.slot >= 0, got, a)
        assert torch.equal(got, wa), i
    n = texel(plan.nr_slot)
    mapped = plan.nr_slot >= 0
    assert torch.equal(torch.where(mapped, (2.0 * n[..., 0] - 1.0) * plan.w_nr, 0.0), du)
    assert torch.equal(torch.where(mapped, (2.0 * n[..., 1] - 1.0) * plan.w_nr, 0.0), dv)
    assert torch.equal(n[..., 2][mapped], rough[mapped])
    assert torch.equal(plan.w_nr, w_nr)


def test_plan_map_weight_is_jax(scene):
    """The plan's w_nr is what the JAX package's apply_image_textures
    returns on the same planes, bit for bit."""
    s = scene
    f = jax.jit(lambda *a: jtx.apply_image_textures(
        a[0], *a[1:7], jtx.load_factors(), tex_phase=a[7], with_nr=True)[1][3])
    # JAX's sample gathers flat planes: one pixel a row, its frame's phase.
    flat = lambda x: np.asarray(x.expand(s["t"].shape)).reshape(-1)
    planes = [flat(x) for x in (s["lx"], s["ly"], s["lz"], *s["pw"][:2], s["cls"], s["phase"])]
    ones = jnp.ones(planes[0].shape, jnp.float32)
    jw = f((ones, ones, ones), *planes)
    np.testing.assert_array_equal(flat(s["plan"].w_nr), np.asarray(jw))
    assert (np.asarray(jw) > 0).any()


def test_plan_counts_are_the_class_rule(scene):
    """The bound's pixel counts (chip_smoke.py's texture stage: pixels that
    sample the texel table, pixels with a normal map) read from the plan
    are those of the class and height rule that counted them before it."""
    s, plan = scene, scene["plan"]
    hit, cls, lz = torch.isfinite(s["t"]), s["cls"], s["lz"]
    sampled = hit & ((cls == -1) | (cls == 1) | ((cls == 4) & (lz < 0.55))
                     | ((cls == 5) & (lz < 1.58)))
    w_nr = textures.apply_image_textures(s["albedo"], s["lx"], s["ly"], lz, s["pw"][0],
                                         s["pw"][1], cls, s["texels"], s["phase"])[1][3]
    assert torch.equal(plan.slot >= 0, sampled)
    assert torch.equal(plan.w_nr > 0, hit & (w_nr > 0))
    assert int(sampled.sum()) > 0.5 * int(hit.sum())


def test_plan_takes_r_xy_and_theta_only_on_their_rungs(scene):
    """The plan marks r_xy on tree pixels and theta on trunks and garments,
    the rungs of the ladder that read them, as the kernel computes them:
    no sky pixel and fewer than the hit pixels."""
    s, plan = scene, scene["plan"]
    hit, cls, lx, ly, lz = torch.isfinite(s["t"]), s["cls"], s["lx"], s["ly"], s["lz"]
    tree = hit & (cls == 1.0)
    trunk = tree & (torch.sqrt(lx * lx + ly * ly) < 0.45) & (lz < 3.2)
    garment = hit & (cls == 5.0) & (lz < 1.58)
    assert torch.equal(plan.takes_r_xy, tree)
    assert torch.equal(plan.takes_theta, trunk | garment)
    assert trunk.any() and garment.any() and (tree & ~trunk).any()
    assert int((plan.takes_r_xy | plan.takes_theta).sum()) < int(hit.sum())


@pytest.mark.parametrize("variant", ("textured",) + rgb_kernel.VARIANTS)
def test_bound_charges_sky_pixels_their_path(scene, variant):
    """chip_smoke.py's RGB bound charges a sky pixel only its ray, the sky
    gradient and three gamma chains, in every variant: a frame that is all
    sky costs RGB_SKY_OPS a pixel. On the scene the textured variant adds
    to the default's count the texture stage's work, r_xy and theta only
    on the pixels whose rung reads them."""
    import chip_smoke
    s = scene
    ao = rgb_kernel.ao_table(*s["ao_args"])
    sky_t = torch.full_like(s["t"], float("inf"))
    sky_inst = torch.full_like(s["inst"], -2)
    ops = chip_smoke.rgb_variant_bound(variant, sky_t, sky_inst, s["table"], ao, s["par"],
                                       s["texels"])[2]
    assert ops == sky_t.numel() * chip_smoke.RGB_SKY_OPS
    if variant != "textured":
        return
    plan, hit = s["plan"], torch.isfinite(s["t"])
    ops = chip_smoke.rgb_variant_bound(variant, s["t"], s["inst"], s["table"], ao, s["par"],
                                       s["texels"])[2]
    stage = (int(hit.sum()) * chip_smoke.RGB_TEX_HIT_OPS
             + int(plan.takes_r_xy.sum()) * chip_smoke.RGB_TEX_R_XY_OPS
             + int(plan.takes_theta.sum()) * chip_smoke.RGB_TEX_THETA_OPS
             + int((plan.slot >= 0).sum()) * chip_smoke.RGB_TEX_SAMPLE_OPS
             + int((plan.w_nr > 0).sum()) * chip_smoke.RGB_TEX_MAP_OPS)
    assert ops == chip_smoke.rgb_default_ops(s["t"], s["inst"], ao, s["par"]) + stage
