"""The port's shading functions and the plain version of the RGB kernel,
held against the JAX package's shading tier and, for one small case, the
Pallas RGB kernel in interpret mode.

Tolerances (tests/test_rgb_kernel.py): with the hash noise off the images
agree to a mean |diff| < 0.5 u8 with |diff| > 1 on < 2% of pixels (ulp
flips on pattern boundaries) and sky pixels exact; with the noise on
(sin at arguments ~1500 decorrelates it per backend) the means agree
within 1.0 and the standard deviations within 2.0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.render import annotate as jann
from constructionsceneposeestimation_tpu.render import raycast as jrc
from constructionsceneposeestimation_tpu.render import rgb_kernel as jrk
from constructionsceneposeestimation_tpu.render import shading as jsh
from constructionsceneposeestimation_tpu.sample import lighting as jlit
from constructionsceneposeestimation_tpu.sample import placement as jpl
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.render import (annotate, raycast, rgb_kernel,
                                                              shading as sh, sweep_kernel)
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
JCFG = JConfig()
W, H = 64, 48
T = lambda a: torch.as_tensor(np.array(a, np.float32))


def _rgb_agree(a, b, sky):
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    d = np.abs(a - b)
    assert d.mean() < 0.5, d.mean()
    assert (d > 1).mean() < 0.02, (d > 1).mean()
    assert sky.any() and (a[sky] == b[sky]).all()


def _rgb_stats(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert abs(a.mean() - b.mean()) < 1.0
    assert abs(a.std() - b.std()) < 2.0


@pytest.fixture(scope="module")
def frames():
    """Two sampled scenes, cameras and lights, rendered by the JAX jnp
    tier with the noise off and on, and by the port."""
    jroster = jworld.make_roster(JCFG.scene)
    jcaster = jrc.make_raycaster(jroster, scene_cfg=JCFG.scene)
    jintr = jcam.intrinsics_from_apertures(12.0, 25.0, W, H)
    keys = jax.random.split(jax.random.PRNGKey(21), 2)
    poses = jax.jit(jax.vmap(lambda k: jpl.randomize_scene(
        k, jroster, JCFG.scene, JCFG.randomization, articulate_crane=True)[0]))(keys)
    lits = jax.vmap(jlit.sample_lighting)(jax.random.split(jax.random.PRNGKey(22), 2))
    cam = np.array([[9.0, 4.0, 3.0], [-14.0, 8.0, 6.0]], np.float32)
    tgt = np.array([[0.0, 0.0, 1.5], [2.0, 0.0, 1.0]], np.float32)

    def one(pose, c, t, lit):
        w = jworld.build_world(jroster, pose)
        return jann.render_frame(jroster, jcaster, w, c, t, jintr, lighting=lit)

    render = jax.jit(jax.vmap(one))
    out = {}
    roster = world.make_roster(SceneConfig())
    intr = camera.intrinsics_from_apertures(12.0, 25.0, W, H)
    caster = raycast.Raycaster(roster)
    sweeper = sweep_kernel.PixelSweeper(roster, intr, caster)
    pose = convert.scene_pose(poses)
    wt = world.build_world(roster, pose)
    for noise in (False, True):
        jl = lits if noise else lits._replace(tex_strength=jnp.zeros(2, jnp.float32))
        ref = render(poses, cam, tgt, jl)
        mine = annotate.render_frame(roster, caster, sweeper, wt, T(cam), T(tgt), intr,
                                     convert.lighting(jl))
        out[noise] = (ref, mine)
    return dict(out=out, roster=roster, jroster=jroster, intr=intr, jintr=jintr, world=wt,
                sweeper=sweeper, cam=cam, tgt=tgt, lits=lits)


def test_plain_rgb_matches_jnp_tier_noise_off(frames):
    ref, mine = frames["out"][False]
    np.testing.assert_array_equal(mine.instance.numpy(), np.asarray(ref.instance))
    sky = np.asarray(ref.instance) == -2
    _rgb_agree(mine.rgb.numpy(), ref.rgb, np.broadcast_to(sky[..., None], sky.shape + (3,)))


def test_plain_rgb_matches_jnp_tier_noise_on(frames):
    ref, mine = frames["out"][True]
    _rgb_stats(mine.rgb.numpy(), ref.rgb)


def _kernel_inputs(frames, lit):
    """The RGB inputs of both frames as the annotation pass builds them."""
    roster, intr, w = frames["roster"], frames["intr"], frames["world"]
    cam, tgt = T(frames["cam"]), T(frames["tgt"])
    M = camera.look_at_matrix(cam, tgt)
    t, code = raycast._unpack(frames["sweeper"](w, cam, M))
    hit = t < raycast.INF * 0.99
    t = torch.where(hit, t, float("inf")).reshape(2, H, W)
    inst = (code - 2).reshape(2, H, W).to(torch.int32)
    depth = t * torch.sum(camera.pixel_rays(intr, M) * (-M[:, :, 0])[:, None, None], -1)
    t = torch.where(depth >= 250.0, float("inf"), t)
    inst = torch.where(depth >= 250.0, -2, inst).to(torch.int32)
    return (t, inst, rgb_kernel.instance_table(roster, w["inst_rot"], w["inst_pos"]),
            rgb_kernel.ao_table(roster, w["inst_pos"]),
            rgb_kernel.rgb_params(M, cam, intr, lit), M)


def test_plain_rgb_matches_pallas_kernel(frames):
    """The plain version against the TPU kernel (interpret mode), fed the
    same f32 per-pixel table rows."""
    jl = frames["lits"]._replace(tex_strength=jnp.zeros(2, jnp.float32))
    lit = convert.lighting(jl)
    t, inst, table, ao, par, M = _kernel_inputs(frames, lit)
    mine = rgb_kernel.plain_rgb(t, inst, table, ao, par)
    rows, foot_r = rgb_kernel.ao_rows(frames["roster"])
    n_inst = table.shape[1] - 2
    i = 0
    idx = torch.where(inst[i] >= 0, inst[i], n_inst - 1 - inst[i]).long().reshape(-1)
    px_tab = jnp.asarray(table[i][idx].T.numpy())  # (16, H*W)
    lit_i = jax.tree_util.tree_map(lambda x: x[i], jl)
    ref = jrk.fused_rgb(jnp.asarray(t[i].numpy()), px_tab, jnp.asarray(frames["cam"][i]),
                        jnp.asarray(M[i].numpy()), frames["jintr"], lit_i,
                        jnp.asarray(frames["world"]["inst_pos"][i, rows, :2].numpy()),
                        jnp.asarray(foot_r), interpret=True)
    sky = (inst[i] == -2).numpy()
    _rgb_agree(mine[i].numpy(), ref, np.broadcast_to(sky[..., None], sky.shape + (3,)))


def test_fused_rgb_dispatches_plain_on_cpu(frames):
    lit = convert.lighting(frames["lits"])
    args = _kernel_inputs(frames, lit)[:5]
    before = rgb_kernel.rgb_cuda.launches
    got = rgb_kernel.fused_rgb(*args)
    assert torch.equal(got, rgb_kernel.plain_rgb(*args))
    assert got.shape == (2, H, W, 3) and got.dtype == torch.uint8
    assert rgb_kernel.rgb_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        rgb_kernel.rgb_cuda(*args)


def test_tables_match_reference(frames):
    roster, jroster, w = frames["roster"], frames["jroster"], frames["world"]
    rows, foot_r = rgb_kernel.ao_rows(roster)
    jrows, jfoot = jann._ao_table(jroster, jroster.num_instances)
    np.testing.assert_array_equal(rows, np.asarray(jrows))
    np.testing.assert_array_equal(foot_r, np.asarray(jfoot))
    tab = rgb_kernel.instance_table(roster, w["inst_rot"], w["inst_pos"])
    O = roster.num_instances
    assert tab.shape == (2, O + 2, 16)
    np.testing.assert_array_equal(tab[0, :O, :3].numpy(), roster.inst_albedo)
    np.testing.assert_array_equal(tab[1, :O, 3:12].numpy(), w["inst_rot"][1].reshape(O, 9).numpy())
    np.testing.assert_array_equal(tab[1, :O, 12:15].numpy(), w["inst_pos"][1].numpy())
    np.testing.assert_array_equal(tab[0, :, 15].numpy(),
                                  np.r_[roster.inst_class_id, -1, -2].astype(np.float32))
    np.testing.assert_array_equal(tab[0, O, :3].numpy(), np.float32([0.45, 0.40, 0.35]))
    ao = rgb_kernel.ao_table(roster, w["inst_pos"])
    np.testing.assert_array_equal(ao[1, :, :2].numpy(), w["inst_pos"][1, rows, :2].numpy())


def test_shading_functions_match_reference():
    rng = np.random.RandomState(0)
    c = np.linspace(0, 1, 4097).astype(np.float32)
    np.testing.assert_allclose(sh._gamma22(T(c)).numpy(), np.asarray(jsh._gamma22(c)), atol=1e-6)
    # Procedural patterns on random local coordinates for every class.
    n = 20000
    x, y, z = (rng.uniform(-3, 3, n).astype(np.float32) for _ in range(3))
    z = np.abs(z)
    cls = rng.choice([-1, 0, 1, 2, 4, 5, 8, 9], n).astype(np.float32)
    alb = tuple(rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    jl = jsh.default_lighting()._replace(tex_phase=jnp.float32(0.37), dirt=jnp.float32(0.5))
    ref = jsh.procedural_albedo(tuple(map(jnp.asarray, alb)), x, y, z, cls, jl)
    mine = sh.procedural_albedo(tuple(map(T, alb)), T(x), T(y), T(z), T(cls), T(0.37), T(0.5))
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # Screen-space normals of a smooth surface, then shading with noise off.
    hh, ww = 24, 32
    u, v = np.meshgrid(np.linspace(-1, 1, ww), np.linspace(-1, 1, hh))
    pos = (u.astype(np.float32) * 3, v.astype(np.float32) * 2,
           (0.3 * u * u + 0.2 * v).astype(np.float32))
    rd = tuple(np.broadcast_to(np.float32(k), (hh, ww)) for k in (0.3, 0.4, -0.866))
    mine_n = sh.screen_space_normals(tuple(T(p)[None] for p in pos), tuple(T(r)[None] for r in rd))
    ref_n = jsh.screen_space_normals(pos, rd)
    for a, b in zip(mine_n, ref_n):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-5)
    t = np.where(rng.rand(hh, ww) < 0.2, np.inf, 5.0).astype(np.float32)
    albp = tuple(rng.uniform(0, 1, (hh, ww)).astype(np.float32) for _ in range(3))
    ao = rng.uniform(0.45, 1.0, (hh, ww)).astype(np.float32)
    jl0 = jsh.default_lighting()._replace(tex_strength=jnp.float32(0.0))
    ref_s = jsh.shade(t, ref_n, pos, rd, albp, jl0, ao=ao)
    lit = convert.lighting(jl0, batched=False)
    mine_s = sh.shade(T(t)[None], mine_n, tuple(T(p)[None] for p in pos),
                      tuple(T(r)[None] for r in rd), tuple(T(a)[None] for a in albp), lit,
                      ao=T(ao)[None])
    for a, b in zip(mine_s, ref_s):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-5)


def test_hash_noise_range_and_statistics():
    rng = np.random.RandomState(1)
    p = [T(rng.uniform(-12, 12, 100000)) for _ in range(3)]
    q = sh._hash_noise(*p).numpy()
    assert q.min() >= 0.0 and q.max() < 1.0
    assert abs(q.mean() - 0.5) < 0.01 and abs(q.std() - np.sqrt(1 / 12)) < 0.01
    ref = np.asarray(jsh._hash_noise(*(x.numpy() for x in p)))
    assert abs(ref.mean() - q.mean()) < 0.01
