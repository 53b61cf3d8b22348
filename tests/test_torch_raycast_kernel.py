"""The analytic caster's plain walks (``packed_sweep``, ``exact_sweep``,
``multi_sweep``, which the kernel ``csrc/raycast.cu`` mirrors on the card)
and their tables, against the JAX casters.

Inputs: two sampled scenes, from each a camera's 64 x 48 pixel rays and
its keypoint segments (unnormalized cam -> keypoint vectors), the shadow
rays from the pixel rays' hit points toward the sun, and the hifi tier's
masked roster (``HifiCaster.base``). One jit for each JAX caster.

Tolerances, those of tests/test_torch_raycast.py and
test_torch_analytic.py: the two packages run the same f32 formulas, so
hits and instances agree on > 0.999 of the pixel and shadow rays (> 0.99 of
the segments, which end on surfaces, where an ulp flips a hit) and t to
rtol 3e-4 on the same share."""

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
from constructionsceneposeestimation_tpu_torch.render import meshcast, raycast
from constructionsceneposeestimation_tpu_torch.scene import assets, world

torch.set_num_threads(2)
JCFG = JConfig()
W, H = 64, 48
CAMS = np.array([[9.0, 4.0, 3.0], [-14.0, 8.0, 6.0]], np.float32)
TGTS = np.array([[0.0, 0.0, 1.5], [2.0, 0.0, 1.0]], np.float32)
SUN = np.array([[0.45, 0.3, -0.84], [-0.6, 0.2, -0.77]], np.float32)


# --- the scenes


@pytest.fixture(scope="module")
def scene():
    """Two sampled scenes in both packages, the port's full and masked
    casters, and the rays: pixels then segments (one array a frame), and
    shadow rays from the full caster's pixel hits."""
    jroster = jworld.make_roster(JCFG.scene)
    keys = jax.random.split(jax.random.PRNGKey(41), 2)
    poses = jax.jit(jax.vmap(lambda k: jpl.randomize_scene(
        k, jroster, JCFG.scene, JCFG.randomization, articulate_crane=True)[0]))(keys)
    jw = jax.jit(jax.vmap(lambda p: jworld.build_world(jroster, p)))(poses)
    roster = world.make_roster(SceneConfig())
    w = world.build_world(roster, convert.scene_pose(poses))
    cam, tgt = torch.as_tensor(CAMS), torch.as_tensor(TGTS)
    intr = camera.intrinsics_from_apertures(12.0, 25.0, W, H)
    px = camera.pixel_rays(intr, camera.look_at_matrix(cam, tgt)).reshape(2, -1, 3)
    kp = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"]).reshape(2, -1, 3)
    rays = torch.cat([px, kp - cam[:, None]], dim=1).contiguous()
    full = raycast.Raycaster(roster)
    hifi = meshcast.HifiCaster(roster, grid_hw=(H, W))
    t = full.cast(w, cam, rays)["t"]
    hit_o = cam[:, None] + torch.where(torch.isfinite(t), t, 0.0)[..., None] * rays
    sun = torch.as_tensor(SUN / np.linalg.norm(SUN, axis=-1, keepdims=True))
    shadow_o = (hit_o + 1e-3 * sun[:, None]).contiguous()
    shadow_d = sun[:, None].expand_as(rays).contiguous()
    return dict(jroster=jroster, jw=jw, roster=roster, world=w, cam=cam, rays=rays,
                n_px=px.shape[1], full=full, base=hifi.base, mask=hifi.base_mask,
                shadow_o=shadow_o, shadow_d=shadow_d)


@pytest.fixture(scope="module")
def jax_casts(scene):
    """The JAX casters on the same worlds and rays, one jit each."""
    jroster = scene["jroster"]
    full = jrc.make_raycaster(jroster, scene_cfg=JCFG.scene)
    base = jrc.make_raycaster(jroster, scene_cfg=JCFG.scene, prim_mask=scene["mask"])
    fns = {"cast": jax.jit(jax.vmap(full)), "fast": jax.jit(jax.vmap(full.fast)),
           "multi": jax.jit(jax.vmap(full.fast_multi_origin)),
           "base": jax.jit(jax.vmap(base.fast))}
    o, d = scene["cam"].numpy(), scene["rays"].numpy()
    out = {k: fns[k](scene["jw"], o, d) for k in ("cast", "fast", "base")}
    out["multi"] = fns["multi"](scene["jw"], scene["shadow_o"].numpy(), scene["shadow_d"].numpy())
    return fns, {k: {f: np.asarray(v) for f, v in r.items()} for k, r in out.items()}


def _agree(mine, ref, hit_agree):
    """Hits and instances agree on > ``hit_agree`` of the rays; t to rtol
    3e-4 on the same share of the common hits."""
    hm, hr = np.isfinite(mine["t"]), np.isfinite(ref["t"])
    assert (hm == hr).mean() > hit_agree, (hm == hr).mean()
    both = hm & hr
    assert both.mean() > 0.2
    close = np.abs(mine["t"][both] - ref["t"][both]) <= 3e-4 * np.abs(ref["t"][both])
    assert close.mean() > hit_agree, close.mean()
    assert (mine["inst"][both] == ref["inst"][both]).mean() > hit_agree


def _parts(scene, r):
    """(pixel rays, segments) of each field of ``r`` (B, N, ...)."""
    n = scene["n_px"]
    return ({k: np.asarray(v)[:, :n] for k, v in r.items()},
            {k: np.asarray(v)[:, n:] for k, v in r.items()})


@pytest.mark.parametrize("method", ["fast", "cast", "base"])
def test_caster_matches_jax_on_pixels_and_segments(scene, jax_casts, method):
    caster = scene["base"] if method == "base" else scene["full"]
    call = caster.cast if method == "cast" else caster.fast
    mine = {k: v.numpy() for k, v in call(scene["world"], scene["cam"], scene["rays"]).items()}
    ref = jax_casts[1][method]
    for (m, r), bar in zip(zip(_parts(scene, mine), _parts(scene, ref)), (0.999, 0.99)):
        _agree(m, r, bar)
    if method == "cast":
        # The pixel rays' normals (a segment ends on a keypoint, often a box
        # corner, where the face, and so the normal, is a tie).
        m, r = _parts(scene, mine)[0], _parts(scene, ref)[0]
        both = np.isfinite(m["t"]) & np.isfinite(r["t"])
        assert (m["prim"][both] == r["prim"][both]).mean() > 0.999
        dn = np.abs(m["normal"] - r["normal"]).max(-1)[both]
        assert (dn > 1e-5).mean() < 0.02 and dn.max() < 1e-2, ((dn > 1e-5).mean(), dn.max())


def test_caster_matches_jax_on_shadow_rays(scene, jax_casts):
    mine = scene["full"].fast_multi_origin(scene["world"], scene["shadow_o"], scene["shadow_d"])
    mine = {k: v.numpy() for k, v in mine.items()}
    lit = ~np.isfinite(mine["t"])
    assert 0.05 < lit.mean() < 0.95
    _agree(mine, jax_casts[1]["multi"], 0.999)


@pytest.mark.parametrize("roster_kind", ["full", "base"])
def test_per_origin_walk_at_the_camera_is_the_exact_walk(scene, roster_kind):
    """The exact and per-origin walks share their generic formulas: with
    every origin at the camera, ``multi_sweep`` hits where ``exact_sweep``
    does, with its t truncated to the packed bits and its instance (a
    packed min may resolve a tie within 2^-18 otherwise)."""
    c, w, o, d = scene[roster_kind], scene["world"], scene["cam"], scene["rays"]
    t, prim = raycast.exact_sweep(c.kind_table, w, o, d)
    hit = t < raycast.INF
    code = torch.as_tensor(c.prim_codes)[torch.clamp_min(prim, 0)]
    want = raycast._pack(torch.where(hit, t, raycast.INF), torch.where(hit, code, 0))
    got = raycast.multi_sweep(c.kind_table, w, o[:, None].expand_as(d).contiguous(), d)
    assert torch.equal(raycast._unpack(got)[0] < raycast.INF * 0.99, hit)
    assert 0.3 < hit.float().mean().item() < 1.0
    same = got.view(torch.int32)[hit] == want.view(torch.int32)[hit]
    assert same.float().mean().item() > 0.999


def test_table_rows_follow_the_plain_order(scene):
    """The packed table walks ``_transform_categories`` in ``CATEGORIES``
    order (kinds in ``np.unique`` order, ascending index), the kind table
    ``_kind_groups``; both as the JAX caster groups them, masked too."""
    roster, jroster = scene["roster"], scene["jroster"]
    for caster, mask in ((scene["full"], None), (scene["base"], scene["mask"])):
        keep = np.ones(roster.num_prims, bool) if mask is None else np.asarray(mask)
        jcats = jrc._transform_categories(jroster)
        want = []
        for cat in raycast.CATEGORIES:
            for kind, idx in jcats[cat]:
                idx = idx[keep[idx]]
                op = kind if cat == "gen" else raycast._CATEGORY_OPS[(cat, kind)]
                want += [[op, p, roster.prim_inst[p] + 2, int(cat == "aa_swap")] for p in idx]
        np.testing.assert_array_equal(caster.packed_table.rows, np.asarray(want, np.int32))
        kinds = np.asarray(jroster.prim_kind)
        want = [[k, p, roster.prim_inst[p] + 2, 0] for k in np.unique(kinds)
                for p in np.nonzero((kinds == k) & keep)[0]]
        np.testing.assert_array_equal(caster.kind_table.rows, np.asarray(want, np.int32))
        for table in (caster.packed_table, caster.kind_table):
            s = [g[2] for g in table.groups]
            assert s[0].start == 0 and s[-1].stop == len(table.rows)
            assert all(a.stop == b.start for a, b in zip(s, s[1:]))
    assert scene["full"].packed_table.ops == {2, 3, 8, 9, 10, 11, 12, 13, 14}


def test_axis_sums(scene):
    """``axis_sums``: each row's capsule axis . (ray_o - p) and |ray_o -
    p|^2, by ``torch.sum``; None for a table without an axial capsule."""
    c, w, o = scene["full"], scene["world"], scene["cam"]
    table = c.packed_table
    sums = raycast.axis_sums(table, w, o)
    prim = torch.as_tensor(table.rows[:, 1]).long()
    rel = o[:, None] - w["prim_pos"][:, prim]
    assert sums.shape == (2, len(table.rows), 2)
    assert torch.equal(sums[..., 0], torch.sum(rel * w["prim_rot"][:, prim, :, 2], -1))
    assert torch.equal(sums[..., 1], torch.sum(rel * rel, -1))
    assert raycast.OP_AXIS_CAPSULE not in c.kind_table.ops
    assert raycast.axis_sums(c.kind_table, w, o) is None


def test_duplicated_primitive_resolves_to_the_first_index(scene, jax_casts):
    """Two identical boxes: the exact cast of both packages names the
    first index wherever either is hit (``argmin``'s first index)."""
    roster = scene["roster"]
    boxes = np.nonzero(np.asarray(roster.prim_kind) == assets.BOX)[0]
    i, j = int(boxes[0]), int(boxes[-1])
    w = {k: v.clone() for k, v in scene["world"].items()}
    for k in ("prim_rot", "prim_pos"):
        w[k][:, j] = w[k][:, i]
    w["prim_params"][j] = w["prim_params"][i]
    jw = dict(scene["jw"])
    for k in ("prim_rot", "prim_pos", "prim_params"):
        jw[k] = jnp.asarray(jw[k]).at[:, j].set(jnp.asarray(jw[k])[:, i])
    rng = np.random.RandomState(7)
    n = scene["rays"].shape[1]
    aim = w["prim_pos"][:, i][:, None] + torch.as_tensor(rng.uniform(-1, 1, (2, n, 3)),
                                                         dtype=torch.float32)
    d = (aim - scene["cam"][:, None]).contiguous()
    mine = scene["full"].cast(w, scene["cam"], d)["prim"].numpy()
    ref = np.asarray(jax_casts[0]["cast"](jw, scene["cam"].numpy(), d.numpy())["prim"])
    assert (mine == i).mean() > 0.05 and (ref == i).mean() > 0.05
    assert not (mine == j).any() and not (ref == j).any()
    assert (mine == ref).mean() > 0.999


def test_cpu_rays_never_reach_the_kernels(scene, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA wrapper was called for CPU rays")

    for name in ("packed_cuda", "exact_cuda", "multi_cuda"):
        monkeypatch.setattr(raycast, name, refuse)
    w, o, d = scene["world"], scene["cam"], scene["rays"]
    walks = (raycast.packed_sweep, raycast.exact_sweep, raycast.multi_sweep)
    before = [f.card_calls for f in walks]
    hifi = meshcast.HifiCaster(scene["roster"], grid_hw=(H, W))
    for c in (scene["full"], scene["base"], hifi):
        c.fast(w, o, d)
        c.cast(w, o, d)
        c.fast_multi_origin(w, scene["shadow_o"], scene["shadow_d"])
    scene["full"].packed(w, o, d)
    assert [f.card_calls for f in walks] == before  # counts calls on the card only


@pytest.mark.parametrize("wrapper", ["packed_cuda", "exact_cuda", "multi_cuda"])
def test_wrappers_refuse_cpu_tensors(scene, wrapper):
    c = scene["full"]
    multi = wrapper == "multi_cuda"
    table = c.kind_table if wrapper != "packed_cuda" else c.packed_table
    before = getattr(raycast, wrapper).launches
    with pytest.raises(ValueError, match="CUDA"):
        getattr(raycast, wrapper)(table, scene["world"],
                                  scene["shadow_o"] if multi else scene["cam"], scene["rays"])
    assert getattr(raycast, wrapper).launches == before
