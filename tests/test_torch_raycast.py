"""The port's packed caster and the plain version of the pixel-sweep
kernel, held against the JAX caster (``make_raycaster(...).fast``) and,
for one small case, the Pallas sweep kernel in interpret mode.

Tolerances (tests/test_sweep_kernel.py): the port's caster runs the same
formulas as the JAX caster in float32, so hits, instances and t agree
except for ulp-level flips on grazing quadric silhouettes: hit and
instance agreement > 0.999, t to rtol 3e-4. Against the Pallas kernel
(unit rays, z-slab caps) the raw t agrees to max rel 2e-4 with > 1e-5 on
< 0.5% of pixels."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.render import raycast as jrc
from constructionsceneposeestimation_tpu.render import sweep_kernel as jsk
from constructionsceneposeestimation_tpu.sample import placement as jpl
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.render import raycast, sweep_kernel
from constructionsceneposeestimation_tpu_torch.scene import assets, world

torch.set_num_threads(2)
JCFG = JConfig()
CAMS = [((9.0, 4.0, 3.0), (0.0, 0.0, 1.5)),
        ((-14.0, 8.0, 6.0), (2.0, 0.0, 1.0)),
        ((0.1, 0.1, 25.0), (0.0, 0.0, 0.0))]  # top-down: axis-parallel rays


@pytest.fixture(scope="module")
def scene():
    jroster = jworld.make_roster(JCFG.scene)
    jpose = jax.jit(lambda k: jpl.randomize_scene(k, jroster, JCFG.scene, JCFG.randomization,
                                                  articulate_crane=True)[0])(
        jax.random.PRNGKey(5))
    jw = jax.jit(lambda p: jworld.build_world(jroster, p))(jpose)
    jcaster = jrc.make_raycaster(jroster, scene_cfg=JCFG.scene)
    roster = world.make_roster(SceneConfig())
    w = world.build_world(roster, convert.scene_pose(jpose, batched=False))
    cam = torch.tensor([c for c, _ in CAMS])
    tgt = torch.tensor([t for _, t in CAMS])
    # The same world for all three cameras.
    wb = {k: (v.expand((len(CAMS),) + v.shape[1:]) if v.dim() > 2 and k != "prim_params"
              else v) for k, v in w.items()}
    return jroster, jw, jcaster, roster, wb, cam, tgt


def _hits(t, inst):
    t, inst = np.asarray(t), np.asarray(inst)
    return np.isfinite(t), t, inst


def _agree(mine, ref, hit_agree=0.999):
    """Hit sets agree on > ``hit_agree`` of the rays; where both hit, t
    agrees to rtol 3e-4 and the instance matches on the same share."""
    hm, tm, im = _hits(*mine)
    hr, tr, ir = _hits(*ref)
    assert (hm == hr).mean() > hit_agree
    both = hm & hr
    assert both.sum() > 0.2 * both.size
    close = np.abs(tm[both] - tr[both]) <= 3e-4 * np.abs(tr[both])
    assert close.mean() > hit_agree, close.mean()
    assert (im[both] == ir[both]).mean() > hit_agree


def test_pack_unpack_matches_reference():
    t = np.random.RandomState(0).uniform(0.01, 300, 1000).astype(np.float32)
    code = np.random.RandomState(1).randint(0, 64, 1000).astype(np.int32)
    packed = raycast._pack(torch.as_tensor(t), torch.as_tensor(code))
    ref = np.asarray(jrc._pack(jnp.asarray(t), jnp.asarray(code)))
    np.testing.assert_array_equal(packed.numpy().view(np.int32), ref.view(np.int32))
    tu, cu = raycast._unpack(packed)
    np.testing.assert_array_equal(cu.numpy(), code)
    assert np.all(np.abs(tu.numpy() - t) <= t * 2.0 ** -17)
    assert raycast.INF == jrc.INF and raycast.EPS == jrc.EPS


def test_transform_categories_match_reference(scene):
    jroster, _, _, roster, _, _, _ = scene
    mine, ref = raycast._transform_categories(roster), jrc._transform_categories(jroster)
    assert list(mine) == list(ref)
    for c in ref:
        assert [(k, i.tolist()) for k, i in mine[c]] == [(k, i.tolist()) for k, i in ref[c]], c


def test_caster_pixel_rays_match_reference(scene):
    jroster, jw, jcaster, roster, w, cam, tgt = scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 64, 48)
    jintr = jcam.intrinsics_from_apertures(12.0, 25.0, 64, 48)
    M = camera.look_at_matrix(cam, tgt)
    dirs = camera.pixel_rays(intr, M).reshape(len(CAMS), -1, 3)
    got = raycast.Raycaster(roster).fast(w, cam, dirs)
    fast = jax.jit(jcaster.fast)
    for i, (c, t) in enumerate(CAMS):
        jM = jcam.look_at_matrix(jnp.asarray(c), jnp.asarray(t))
        _, jd = jcam.pixel_rays(jintr, jnp.asarray(c), jM)
        ref = fast(jw, jnp.asarray(c), jd.reshape(-1, 3))
        _agree((got["t"][i].numpy(), got["inst"][i].numpy()), (ref["t"], ref["inst"]))


def test_caster_occlusion_segments_match_reference(scene):
    """Unnormalized cam -> keypoint segments (t in segment units). Box
    keypoints lie on faces and corners, so a segment ends exactly on a
    surface (t ~ 1), where an ulp flips hit/miss or the surface hit: hits,
    t and instances are held to the keypoint-visibility bar (0.99), and so
    is the occlusion decision (t > 1 - 0.02)."""
    jroster, jw, jcaster, roster, w, cam, tgt = scene
    kw = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"]).reshape(3, -1, 3)
    got = raycast.Raycaster(roster).fast(w, cam, kw - cam[:, None])
    fast = jax.jit(jcaster.fast)
    for i, (c, _) in enumerate(CAMS):
        seg = jnp.asarray(kw[i].numpy()) - jnp.asarray(c)
        ref = fast(jw, jnp.asarray(c), seg)
        _agree((got["t"][i].numpy(), got["inst"][i].numpy()), (ref["t"], ref["inst"]),
               hit_agree=0.99)
        beyond = got["t"][i].numpy() > 0.98
        assert (beyond == (np.asarray(ref["t"]) > 0.98)).mean() >= 0.99
        assert not beyond.all()


def test_schedule_covers_every_primitive(scene):
    _, _, _, roster, _, _, _ = scene
    si, sf = sweep_kernel.build_schedule(roster)
    assert sorted(si[:, 1].tolist()) == list(range(roster.num_prims))
    np.testing.assert_array_equal(si[:, 2], roster.prim_inst[si[:, 1]] + 2)
    np.testing.assert_array_equal(sf, roster.prim_params[si[:, 1]])
    kinds = roster.prim_kind[si[:, 1]]
    assert set(si[kinds == assets.CAPSULE, 0]) == {6}
    assert set(si[kinds == assets.PLANE, 0]) == {0}
    assert si[:, 3].sum() == 10  # 10 fence panels run along y (x/y swapped)


def test_plain_sweep_matches_pallas_kernel(scene):
    """The plain version against the TPU kernel itself (interpret mode, one
    camera at 48 x 32)."""
    jroster, jw, _, roster, w, cam, tgt = scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 48, 32)
    jintr = jcam.intrinsics_from_apertures(12.0, 25.0, 48, 32)
    pallas = jsk.make_pixel_sweeper(jroster, jintr, interpret=True)
    sweeper = sweep_kernel.PixelSweeper(roster, intr)
    M = camera.look_at_matrix(cam[:1], tgt[:1])
    w1 = {k: (v[:1] if v.dim() > 2 and k != "prim_params" else v) for k, v in w.items()}
    packed = sweeper(w1, cam[:1], M)
    assert packed.shape == (1, 48 * 32)
    tk, ck = jrc._unpack(pallas(jw, jnp.asarray(cam[0].numpy()), jnp.asarray(M[0].numpy())))
    tp, cp = raycast._unpack(packed[0])
    tk, ck, tp, cp = (np.asarray(x) for x in (tk, ck, tp.numpy(), cp.numpy()))
    hk, hp = tk < jrc.INF * 0.99, tp < raycast.INF * 0.99
    assert (hk == hp).mean() > 0.9995
    both = hk & hp
    rel = np.abs(tk[both] - tp[both]) / tp[both]
    assert rel.max() < 2e-4, rel.max()
    assert (rel > 1e-5).mean() < 0.005
    assert (ck[both] == cp[both]).mean() > 0.999


def test_sweeper_dispatches_plain_on_cpu(scene):
    _, _, _, roster, w, cam, tgt = scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 32, 24)
    M = camera.look_at_matrix(cam, tgt)
    before = sweep_kernel.sweep_cuda.launches
    sweeper = sweep_kernel.PixelSweeper(roster, intr)
    got = sweeper(w, cam, M)
    ref = sweep_kernel.plain_pixel_sweep(raycast.Raycaster(roster), w, cam, M, intr)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert sweep_kernel.sweep_cuda.launches == before
    si, sf, radii = sweeper.schedule("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sweep_kernel.sweep_cuda(si, sf, w, cam, M, intr, radii)
