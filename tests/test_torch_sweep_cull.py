"""The pixel sweep's tile cull, on the CPU: the bounding radii of
``render/sweep_kernel.bounding_radii``, the plain mirror of the kernel's
tile test (``tile_cull_plain``) and the needed-pairs count
(``needed_pairs``) that the sweep's bound charges, on the JAX-sampled scene
and cameras of tests/test_torch_raycast.py.

Tolerances: a hit point comes from the plain caster's f32 t, packed to
2^-18 relative, whose quadric roots lose digits to the cancellation in
|o|^2 - r^2 (~1e-4 m at t ~ 17 m): it may lie up to 2e-5 t outside its
primitive. Radii are widened by 1e-6 relative over the exact extreme-point
distance and must not exceed it by more than 1e-5."""

import numpy as np
import pytest
import torch

import jax

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.sample import placement as jpl
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.render import raycast, sweep_kernel
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
JCFG = JConfig()
CAMS = [((9.0, 4.0, 3.0), (0.0, 0.0, 1.5)),
        ((-14.0, 8.0, 6.0), (2.0, 0.0, 1.0)),
        ((0.1, 0.1, 25.0), (0.0, 0.0, 0.0))]  # top-down: axis-parallel rays
# 100 x 60: ragged tiles at the right (4 columns) and bottom (4 rows) edges.
INTR = camera.intrinsics_from_apertures(12.0, 25.0, 100, 60)


@pytest.fixture(scope="module")
def scene():
    jroster = jworld.make_roster(JCFG.scene)
    jpose = jax.jit(lambda k: jpl.randomize_scene(k, jroster, JCFG.scene, JCFG.randomization,
                                                  articulate_crane=True)[0])(
        jax.random.PRNGKey(5))
    roster = world.make_roster(SceneConfig())
    w = world.build_world(roster, convert.scene_pose(jpose, batched=False))
    cam = torch.tensor([c for c, _ in CAMS])
    tgt = torch.tensor([t for _, t in CAMS])
    wb = {k: (v.expand((len(CAMS),) + v.shape[1:]) if v.dim() > 2 and k != "prim_params"
              else v) for k, v in w.items()}
    si, sf = sweep_kernel.build_schedule(roster)
    radii = sweep_kernel.bounding_radii(si, sf)
    return roster, wb, cam, camera.look_at_matrix(cam, tgt), si, sf, radii


def _extreme_points(op, p):
    """Local-frame extreme points of a primitive of schedule op ``op`` with
    params ``p``: sphere poles, cylinder and cone rims, box corners,
    capsule tips and end-ball surfaces."""
    th = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    ring = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], 1)
    if op == 1:
        u = np.concatenate([ring, np.eye(3), -np.eye(3)])
        return p[0] * u
    if op in (2, 8):
        return np.concatenate([p[0] * ring + [0, 0, s * p[1]] for s in (-1, 1)])
    if op == 3:
        return np.concatenate([p[0] * ring - [0, 0, p[2]], p[1] * ring + [0, 0, p[2]]])
    if op in (4, 5, 7):
        s = np.array([[i, j, k] for i in (-1, 1) for j in (-1, 1) for k in (-1, 1)])
        return s * p[:3]
    if op == 6:
        ph = np.linspace(0.0, np.pi, 17)
        ball = np.stack([np.outer(np.sin(ph), np.cos(th)).ravel(),
                         np.outer(np.sin(ph), np.sin(th)).ravel(),
                         np.repeat(np.cos(ph), len(th))], 1)
        return np.concatenate([p[0] * ball + [0, 0, s * p[1]] for s in (-1, 1)])
    raise ValueError(op)


@pytest.mark.parametrize("ops", [(1,), (2, 8), (3,), (4, 5, 7), (6,)],
                         ids=["sphere", "cylinder", "cone", "box", "capsule"])
def test_bounding_radius_holds_extreme_points(scene, ops):
    """The roster's rows of each kind and random parameters: every extreme
    point lies within the radius, and the farthest one reaches it."""
    *_, si, sf, radii = scene
    rng = np.random.RandomState(sum(ops))
    rows = [(int(o), f, r) for o, f, r in zip(si[:, 0], sf, radii) if o in ops]
    rand_f = rng.uniform(0.01, 3.0, (20, 4)).astype(np.float32)
    rand_i = np.zeros((20, 4), np.int32)
    rand_i[:, 0] = rng.choice(ops, 20)
    rows += [(int(o), f, r) for o, f, r in
             zip(rand_i[:, 0], rand_f, sweep_kernel.bounding_radii(rand_i, rand_f))]
    assert len(rows) >= 20
    for op, f, r in rows:
        far = np.linalg.norm(_extreme_points(op, f.astype(np.float64)), axis=1).max()
        assert far <= r and r <= far * (1 + 1e-5), (op, f, r, far)


@pytest.mark.parametrize("cam_i", range(len(CAMS)))
def test_hits_lie_in_a_kept_bounding_sphere(scene, cam_i):
    """Every hit of the plain sweep, off the ground, lies within the
    bounding sphere of a row of its instance that its tile keeps."""
    roster, w, cam, M, si, sf, radii = scene
    si_t, radii_t = torch.as_tensor(si), torch.as_tensor(radii)
    keep = sweep_kernel.tile_cull_plain(si_t, radii_t, w, cam, M, INTR)[cam_i]
    tx, ty = -(-INTR.width // sweep_kernel.TILE[0]), -(-INTR.height // sweep_kernel.TILE[1])
    assert keep.shape == (ty, tx, len(si))
    packed = sweep_kernel.plain_pixel_sweep(raycast.Raycaster(roster), w, cam, M, INTR)[cam_i]
    t, code = raycast._unpack(packed)
    d = camera.pixel_rays(INTR, M[cam_i:cam_i + 1]).reshape(-1, 3)
    hit = (t < raycast.INF * 0.99) & (code != 1)  # code 1: the ground plane
    assert hit.sum() > 100
    p = cam[cam_i] + t[:, None] * d
    centres = w["prim_pos"][cam_i, si_t[:, 1].long()]
    inside = (torch.linalg.norm(p[:, None] - centres[None], dim=-1)
              <= radii_t * (1 + 1e-5) + 2e-5 * t[:, None] + 1e-6)  # (N, S)
    rows, cols = torch.meshgrid(torch.arange(INTR.height), torch.arange(INTR.width),
                                indexing="ij")
    tile_keep = keep[rows.reshape(-1) // sweep_kernel.TILE[1],
                     cols.reshape(-1) // sweep_kernel.TILE[0]]  # (N, S)
    own = code[:, None] == si_t[:, 2]
    covered = (inside & own & tile_keep).any(1)
    assert covered[hit].all(), int((~covered & hit).sum())
    # The cull does cut the walk: fewer rows than the schedule on average.
    assert keep.float().sum(-1).mean() < len(si)


@pytest.mark.parametrize("cam_i", range(len(CAMS)))
def test_needed_pairs_between_one_and_brute_force(scene, cam_i):
    """At least the plane and at most every row per pixel; and every row
    whose sphere a pixel's ray meets is kept by that pixel's tile."""
    _, w, cam, M, si, _, radii = scene
    si_t, radii_t = torch.as_tensor(si), torch.as_tensor(radii)
    sl = slice(cam_i, cam_i + 1)
    w1 = {k: (v[sl] if v.dim() > 2 and k != "prim_params" else v) for k, v in w.items()}
    row_px, px_rows = sweep_kernel.needed_pairs(si_t, radii_t, w1, cam[sl], M[sl], INTR)
    n_px = INTR.width * INTR.height
    assert row_px.shape == (1, len(si)) and px_rows.shape == (1, n_px)
    assert int(px_rows.min()) >= 1 and int(px_rows.max()) <= len(si)
    assert int(row_px.sum()) == int(px_rows.sum())
    assert int(row_px[0, si[:, 0] == 0].sum()) == n_px  # the plane, every pixel
    assert int(px_rows.sum()) < n_px * len(si)
    # Conservative cull: a needed row is never dropped by the pixel's tile.
    keep = sweep_kernel.tile_cull_plain(si_t, radii_t, w1, cam[sl], M[sl], INTR)[0]
    d = camera.pixel_rays(INTR, M[sl]).reshape(-1, 3)
    v = w1["prim_pos"][0, si_t[:, 1].long()] - cam[cam_i]
    tc = d @ v.T
    vv = (v * v).sum(-1)
    meet = ((tc > 0) & (vv - tc * tc <= radii_t ** 2)) | (vv <= radii_t ** 2)
    rows, cols = torch.meshgrid(torch.arange(INTR.height), torch.arange(INTR.width),
                                indexing="ij")
    tile_keep = keep[rows.reshape(-1) // sweep_kernel.TILE[1],
                     cols.reshape(-1) // sweep_kernel.TILE[0]]
    assert not (meet & ~tile_keep).any()
