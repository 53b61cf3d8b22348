"""The analytic caster kernel's bundle cull (``csrc/raycast.cu``), through
its plain mirror ``raycast.bundle_cull_plain`` and the rows' bounding radii
``raycast.row_radii``, on the CPU.

The kernel walks, for each warp of 32 consecutive rays of a frame, only the
rows the warp's cone keeps. It is bit-equal to the brute-force plain walks
if every culled (ray, row) pair misses in them: t = INF, so pack(INF, code)
in the packed walks. These tests hold that on the mirror of the cull:

* the kept set holds every (ray, row) pair whose half-line meets the row's
  bounding sphere (``raycast.needed_rows``), on pixel, shadow and segment
  rays, full and masked rosters;
* the plain walk over each warp's kept rows, the culled rows' misses folded
  in, equals the full plain walk bit for bit, in all three modes and with
  an excluded instance a ray;
* a bundle wider than pi / 2 keeps every row, an origin inside a sphere
  keeps it, a warp mixing camera and surface origins stays conservative;
* ``occlusion_ts`` (the exact walk with each segment's own instance
  excluded) agrees with the JAX package's.

Inputs: two sampled scenes, each camera's 64 x 64 pixel rays and its
keypoint segments, the shadow rays from the pixel hits toward the sun.
Tolerances for the JAX comparison are those of tests/test_torch_helpers.py;
everything else is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.render import raycast as jrc
from constructionsceneposeestimation_tpu.sample import placement as jpl
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.render import meshcast, raycast, sweep_kernel
from constructionsceneposeestimation_tpu_torch.scene import assets, world

torch.set_num_threads(2)
JCFG = JConfig()
W = H = 64
CAMS = np.array([[9.0, 4.0, 3.0], [-14.0, 8.0, 6.0]], np.float32)
TGTS = np.array([[0.0, 0.0, 1.5], [2.0, 0.0, 1.0]], np.float32)
SUN = np.array([[0.45, 0.3, 0.84], [-0.6, 0.2, 0.77]], np.float32)
INF = float(raycast.INF)


@pytest.fixture(scope="module")
def scene():
    """Two sampled scenes (the JAX world too, for ``occlusion_ts``), the
    full and masked casters, and the rays: pixels then segments (the
    segments start on a warp boundary, their last warp holds 8 rays), and
    the shadow rays from the full caster's hits toward the sun."""
    jroster = jworld.make_roster(JCFG.scene)
    keys = jax.random.split(jax.random.PRNGKey(23), 2)
    poses = jax.jit(jax.vmap(lambda k: jpl.randomize_scene(
        k, jroster, JCFG.scene, JCFG.randomization, articulate_crane=True)[0]))(keys)
    jw = jax.jit(jax.vmap(lambda p: jworld.build_world(jroster, p)))(poses)
    roster = world.make_roster(SceneConfig())
    w = world.build_world(roster, convert.scene_pose(poses))
    cam, tgt = torch.as_tensor(CAMS), torch.as_tensor(TGTS)
    intr = camera.intrinsics_from_apertures(12.0, 25.0, W, H)
    px = camera.pixel_rays(intr, camera.look_at_matrix(cam, tgt)).reshape(2, -1, 3)
    kp = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"])
    seg = kp.reshape(2, -1, 3) - cam[:, None]
    full = raycast.Raycaster(roster)
    base = meshcast.HifiCaster(roster, grid_hw=(H, W)).base
    t = full.plain_cast(w, cam, px)["t"]
    sun = torch.as_tensor(SUN / np.linalg.norm(SUN, axis=-1, keepdims=True))
    shadow_o = (cam[:, None] + torch.where(torch.isfinite(t), t, 0.0)[..., None] * px
                + 1e-3 * sun[:, None]).contiguous()
    return dict(jroster=jroster, jw=jw, roster=roster, world=w, cam=cam, px=px, seg=seg,
                n_kpts=kp.shape[2], full=full, base=base, shadow_o=shadow_o,
                shadow_d=sun[:, None].expand_as(px).contiguous())


def _rays(scene, kind):
    """(table attribute, ray_o, ray_d) of a ray set."""
    if kind == "pixels":
        return "kind_table", scene["cam"], scene["px"]
    if kind == "segments":
        return "packed_table", scene["cam"], scene["seg"]
    return "kind_table", scene["shadow_o"], scene["shadow_d"]


def _per_ray(kept, n):
    """(B, W, S) warp keeps -> (B, n, S) for each ray."""
    return kept.repeat_interleave(raycast.WARP, dim=1)[:, :n]


def _cull(table, w, ray_o, ray_d):
    return raycast.bundle_cull_plain(table, torch.as_tensor(table.radii), w, ray_o, ray_d)


def _row_values(caster, table, mode, w, ray_o, ray_d, exclude=None):
    """(B, N, S): each row's own plain walk (a table of that row alone):
    packed values in the packed modes, t in the exact one."""
    params = np.asarray(caster.roster.prim_params)
    out = []
    for cat, kind, sl in table.groups:
        for s in range(sl.start, sl.stop):
            sub = raycast.SweepTable([(cat, kind, int(table.rows[s, 0]), [table.rows[s, 1]])],
                                     caster.prim_codes, params)
            if mode == "packed":
                out.append(raycast.packed_sweep(sub, w, ray_o, ray_d,
                                                raycast.axis_sums(sub, w, ray_o)))
            elif mode == "multi":
                out.append(raycast.multi_sweep(sub, w, ray_o, ray_d))
            else:
                out.append(raycast.exact_sweep(sub, w, ray_o, ray_d, exclude)[0])
    return torch.stack(out, -1)


def _check_kept_walk(caster, table, mode, w, ray_o, ray_d, kept, exclude=None):
    """Every culled pair misses in the plain walk, and the walk over the
    kept rows (the culled rows' pack(INF, code) folded in for the packed
    modes, as the kernel does) equals the full plain walk bit for bit."""
    keep = _per_ray(kept, ray_d.shape[1])
    vals = _row_values(caster, table, mode, w, ray_o, ray_d, exclude)
    bits = lambda x: x.contiguous().view(torch.int32)
    if mode == "exact":
        assert bool((vals[~keep] == INF).all())
        t, arg = torch.min(torch.where(keep, vals, INF), dim=-1)  # first index on a tie
        t_full, prim_full = raycast.exact_sweep(table, w, ray_o, ray_d, exclude)
        assert torch.equal(bits(t), bits(t_full))
        prim = torch.where(t < INF, torch.as_tensor(table.rows[:, 1]).long()[arg], -1)
        assert torch.equal(prim, prim_full)
        return
    miss = raycast._pack(torch.full((len(table.rows),), INF),
                         torch.as_tensor(table.rows[:, 2]))
    miss = torch.minimum(miss, torch.tensor(INF))  # a one-row walk starts at INF too
    assert torch.equal(bits(vals)[~keep], bits(miss.expand_as(vals))[~keep])
    best = torch.minimum(torch.where(keep, vals, miss).amin(-1), torch.tensor(INF))
    if mode == "packed":
        full = raycast.packed_sweep(table, w, ray_o, ray_d, raycast.axis_sums(table, w, ray_o))
    else:
        full = raycast.multi_sweep(table, w, ray_o, ray_d)
    assert torch.equal(bits(best), bits(full))


def _frozen_bounding_radii(sched_i, sched_f):
    """``sweep_kernel.bounding_radii`` as it was before ``raycast.kind_radii``
    took its formulas over (a frozen copy)."""
    op, f = sched_i[:, 0], sched_f.astype(np.float64)
    rad = np.full(len(op), -1.0)
    box = np.isin(op, (4, 5, 7))
    cyl = np.isin(op, (2, 8))
    rad[op == 1] = f[op == 1, 0]
    rad[cyl] = np.hypot(f[cyl, 0], f[cyl, 1])
    cone = op == 3
    rad[cone] = np.hypot(np.maximum(f[cone, 0], f[cone, 1]), f[cone, 2])
    rad[box] = np.linalg.norm(f[box, :3], axis=1)
    rad[op == 6] = f[op == 6, 0] + f[op == 6, 1]
    return np.where(rad > 0, rad * (1.0 + 1e-6), rad).astype(np.float32)


def test_row_radii_are_the_radii_row_meets_used(scene):
    """``row_radii`` (on every table) equals what chip_smoke.py's
    ``row_meets`` built before: ``sweep_kernel.bounding_radii`` of the
    pixel sweep's operation for the row's kind, on its parameters (a frozen
    copy); the pixel sweep's own radii are unchanged too."""
    roster = scene["roster"]
    op = {assets.PLANE: 0, assets.SPHERE: 1, assets.CYLINDER: 2, assets.CONE: 3,
          assets.BOX: 4, assets.CAPSULE: 6}
    for caster in (scene["full"], scene["base"]):
        for table in (caster.packed_table, caster.kind_table):
            prim = table.rows[:, 1]
            kinds = np.asarray(roster.prim_kind)[prim]
            sched_i = np.stack([np.asarray([op[int(k)] for k in kinds]), prim], -1)
            want = _frozen_bounding_radii(sched_i, np.asarray(roster.prim_params)[prim])
            assert table.radii.dtype == np.float32
            np.testing.assert_array_equal(table.radii, want)
            assert ((table.radii < 0) == (kinds == assets.PLANE)).all()
    assert len(scene["base"].kind_table.rows) < len(scene["full"].kind_table.rows)
    sched_i, sched_f = sweep_kernel.build_schedule(roster)
    np.testing.assert_array_equal(sweep_kernel.bounding_radii(sched_i, sched_f),
                                  _frozen_bounding_radii(sched_i, sched_f))


@pytest.mark.parametrize("roster_kind", ["full", "base"])
@pytest.mark.parametrize("rays", ["pixels", "segments", "shadow"])
def test_bundle_cull_keeps_every_needed_pair(scene, rays, roster_kind):
    """Each warp keeps every row that one of its rays' half-lines meets,
    and culls most of the rest."""
    caster = scene[roster_kind]
    attr, ray_o, ray_d = _rays(scene, rays)
    table = getattr(caster, attr)
    kept = _cull(table, scene["world"], ray_o, ray_d)
    n = ray_d.shape[1]
    assert kept.shape == (2, -(-n // 32), len(table.rows))
    needed = raycast.needed_rows(table, scene["world"], ray_o, ray_d)
    assert not bool((needed & ~_per_ray(kept, n)).any())
    assert needed.any(-1).all()  # the plane
    if roster_kind == "full":  # the masked roster keeps 12 rows, most of them large
        assert kept.float().mean().item() < 0.5, kept.float().mean().item()


@pytest.mark.parametrize("roster_kind", ["full", "base"])
@pytest.mark.parametrize("mode", ["packed", "exact", "exclude", "multi"])
def test_walk_over_kept_rows_is_the_full_walk(scene, mode, roster_kind):
    """The plain walk restricted to each warp's kept rows equals the full
    plain walk bit for bit: the packed walk on pixels then segments, the
    exact walk on the same rays (with each segment's own instance, and a
    pixel's instance 7, excluded), the per-origin walk on the shadow rays."""
    caster, w = scene[roster_kind], scene["world"]
    exclude = None
    if mode == "multi":
        table, ray_o, ray_d = caster.kind_table, scene["shadow_o"], scene["shadow_d"]
    else:
        table = caster.packed_table if mode == "packed" else caster.kind_table
        ray_o, ray_d = scene["cam"], torch.cat([scene["px"], scene["seg"]], 1).contiguous()
        if mode == "exclude":
            n_px, n_seg = scene["px"].shape[1], scene["seg"].shape[1]
            own = torch.arange(n_seg) // scene["n_kpts"]
            exclude = torch.cat([torch.full((n_px,), 7), own]).expand(2, -1).to(torch.int32)
    kept = _cull(table, w, ray_o, ray_d)
    _check_kept_walk(caster, table, "exact" if mode == "exclude" else mode, w, ray_o, ray_d,
                     kept, exclude)


def test_kept_rows_unpacks_the_kernel_words(scene):
    """``kept_rows`` reads bit s % 32 of word s // 32 as row s (bit 31 the
    sign bit of the int32 word); ``kept_buffer`` has the words' shape."""
    table = scene["full"].kind_table
    keep = _cull(table, scene["world"], scene["cam"], scene["seg"])  # (2, 22, 76)
    S = keep.shape[-1]
    padded = np.zeros(keep.shape[:2] + (3 * 32,), bool)
    padded[..., :S] = keep.numpy()
    words = (padded.reshape(*keep.shape[:2], 3, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32).view(np.int32)
    assert (words < 0).any()
    buf = raycast.kept_buffer(table, scene["seg"])
    assert buf.shape == words.shape and buf.dtype == torch.int32
    assert torch.equal(raycast.kept_rows(torch.as_tensor(words), S), keep)


def test_wide_bundle_keeps_every_row(scene):
    """A warp whose directions span more than pi / 2 keeps every row; one
    looking straight up from the camera keeps little but the plane."""
    table = scene["full"].packed_table
    ang = torch.linspace(-1.7, 1.7, 32)  # 3.4 rad across the warp
    wide = torch.stack([torch.cos(ang), torch.sin(ang), torch.full_like(ang, -0.2)], -1)
    up = torch.tensor([0.0, 0.0, 1.0]).expand(32, 3)
    d = torch.cat([wide, up])[None].expand(2, 64, 3).contiguous()
    kept = _cull(table, scene["world"], scene["cam"], d)
    assert bool(kept[:, 0].all())
    assert kept[:, 1].float().mean().item() < 0.25
    _check_kept_walk(scene["full"], table, "packed", scene["world"], scene["cam"], d, kept)


def test_origin_inside_a_sphere_keeps_it(scene):
    """Shadow origins and a camera inside a tree crown's bounding sphere,
    looking away from its centre: the crown's row is kept whatever the
    angle, and the kept walks still equal the full ones."""
    caster, w = scene["full"], scene["world"]
    table = caster.kind_table
    roster = scene["roster"]
    crowns = [s for s, (op, p) in enumerate(table.rows[:, :2])
              if op == assets.SPHERE and roster.prim_params[p][0] > 2.0]
    s = crowns[0]
    centre = w["prim_pos"][:, table.rows[s, 1]]  # (2, 3)
    inside = centre + torch.tensor([0.4, -0.3, 0.6])
    up = torch.tensor([0.2, 0.1, 0.97]).expand(2, 64, 3).contiguous()
    o = (inside[:, None] + 0.05 * torch.randn(2, 64, 3, generator=torch.Generator().manual_seed(1)))
    kept = _cull(table, w, o.contiguous(), up)
    assert bool(kept[..., s].all())
    _check_kept_walk(caster, table, "multi", w, o.contiguous(), up, kept)
    kept = _cull(table, w, inside.contiguous(), up)
    assert bool(kept[..., s].all())
    _check_kept_walk(caster, table, "exact", w, inside.contiguous(), up, kept)


def test_warp_mixing_camera_and_surface_origins_stays_conservative(scene):
    """Shadow warps whose sky pixels start at the camera (as render_frame
    builds them): the origins' spread widens every ball, so the warps keep
    more rows than with surface origins alone, every needed row among them,
    and the kept walk equals the full one."""
    caster, w = scene["full"], scene["world"]
    table = caster.kind_table
    o, d = scene["shadow_o"].clone(), scene["shadow_d"]
    sky = torch.zeros(o.shape[:2], dtype=torch.bool)
    sky[:, 1::2] = True  # every other ray of every warp
    o[sky] = (scene["cam"][:, None].expand_as(o) + 1e-3 * d)[sky]
    mixed, surface = _cull(table, w, o, d), _cull(table, w, scene["shadow_o"], d)
    assert mixed.sum().item() > surface.sum().item()
    assert not bool((raycast.needed_rows(table, w, o, d) & ~_per_ray(mixed, o.shape[1])).any())
    _check_kept_walk(caster, table, "multi", w, o, d, mixed)


def test_occlusion_ts_matches_jax_with_own_instance_excluded(scene):
    """``occlusion_ts`` of each keypoint segment with its own instance
    excluded (the keypoint occlusion test), against the JAX package's: hit
    sets on > 0.99 of the segments (they end on surfaces), t to rtol 3e-4
    on > 0.99 of the common hits."""
    own = (torch.arange(scene["seg"].shape[1]) // scene["n_kpts"]).to(torch.int32)
    excl = own.expand(2, -1).contiguous()
    got = raycast.occlusion_ts(scene["world"], scene["roster"], scene["cam"], scene["seg"], excl)
    fn = jax.jit(jax.vmap(lambda w, o, d, e: jrc.occlusion_ts(w, scene["jroster"], o, d, e)))
    want = np.asarray(fn(scene["jw"], CAMS, scene["seg"].numpy(), excl.numpy()))
    g = got.numpy()
    assert ((want < 1e9) == (g < 1e9)).mean() > 0.99
    hit = (want < 1e9) & (g < 1e9)
    assert 0.05 < hit.mean() < 1.0
    assert (np.abs(g[hit] - want[hit]) <= 3e-4 * want[hit]).mean() > 0.99
    # The exclusion only removes rows: t never falls below the walk's own.
    t_all = raycast.exact_sweep(scene["full"].kind_table, scene["world"], scene["cam"],
                                scene["seg"])[0]
    assert bool((got >= t_all).all()) and bool((got > t_all).any())
