"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit; elsewhere they skip. They
import no JAX, so on a host without it run them without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of the CPU parity tests (tests/test_torch_raycast.py,
test_torch_rgb.py, test_torch_heatmap.py), on the TPU kernel's own test
cameras, plus RGB at a ragged 250 x 190 seen from the horizon and
straight down, and heatmaps at odd sizes, a row pitch that is not 16-byte
aligned, and with no, all or off-map keypoints. Instance tables and
keypoint slots too large for a block's shared memory are refused without
a launch. The peak kernel's
blur, NMS and selection are bit-equal to its
plain version by construction (csrc/peaks.cu), its DARK offsets are held
to 1e-3 heatmap px. The sweep's tile cull skips only rows no ray of the
tile can hit, so the kernel is bit-equal to itself with every row kept,
and its tolerances are those of the full walk. The sweep's 2e-4 bound on
relative t excludes grazing rays (disc
~ 0 on a quadric, or a flip to the surface behind), which measured 7.2e-6
of 9.7M hit pixels at 64 x 512^2: up to 1e-4 of the hit pixels may exceed
it. The mesh terms kernel rounds the corners in FMA chains where its plain
version runs torch.einsum: each part is held within 8 units of
``meshcast.terms_gap`` (ulps of the corners' scale times the part's
derivative by a corner), the exact zeros of cr and the -1 radii bit for
bit, and the sweep over its terms to the sweep over the plain ones."""

import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.ops import decode, heatmap, peak_kernel
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import FrameBatch, Pipeline
from constructionsceneposeestimation_tpu_torch.render import (meshcast, raycast, rgb_kernel,
                                                              sweep_kernel)
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


def _check_sweep(roster, w, cam, tgt, intr, prim_mask=None):
    sweeper = sweep_kernel.PixelSweeper(roster, intr, prim_mask=prim_mask)
    M = camera.look_at_matrix(cam, tgt)
    before = sweep_kernel.sweep_cuda.launches
    packed = sweeper(w, cam, M)
    assert sweep_kernel.sweep_cuda.launches == before + 1
    # With radii beyond any distance every tile keeps every row: the cull
    # must not change a bit of the packed min.
    si, sf, radii = sweeper.schedule(cam.device)
    full = sweep_kernel.sweep_cuda(si, sf, w, cam, M, intr, torch.full_like(radii, 1e15))
    assert torch.equal(packed.view(torch.int32), full.view(torch.int32))
    tk, ck = raycast._unpack(packed)
    tp, cp = raycast._unpack(sweep_kernel.plain_pixel_sweep(sweeper.caster, w, cam, M, intr))
    torch.cuda.synchronize()
    hk, hp = tk < raycast.INF * 0.99, tp < raycast.INF * 0.99
    assert (hk == hp).float().mean() > 0.9995
    both = hk & hp
    rel = (torch.abs(tk - tp) / tp)[both]
    assert (rel > 2e-4).float().mean() < 1e-4
    assert (rel > 1e-5).float().mean() < 0.005
    assert (ck[both] == cp[both]).float().mean() > 0.999


@pytest.mark.parametrize("size", [(256, 192), (250, 190)])
def test_sweep_kernel_matches_plain(scene, size):
    """256 x 192, and 250 x 190 where the right and bottom tiles are ragged."""
    roster, w, cam, tgt = scene
    _check_sweep(roster, w, cam, tgt, camera.intrinsics_from_apertures(12.0, 25.0, *size))


def test_sweep_kernel_masked_schedule_matches_plain(scene):
    """The hifi tier's schedule, without the primitives its meshes replace,
    against the plain caster built with the same mask."""
    roster, w, cam, tgt = scene
    covered = meshcast.make_mesh_caster(roster).covered_prims
    _check_sweep(roster, w, cam, tgt, camera.intrinsics_from_apertures(12.0, 25.0, 256, 192),
                 prim_mask=~covered)


def test_sweep_kernel_camera_inside_a_crown(scene):
    """Cameras inside a tree crown's bounding sphere (the tile cull keeps
    it whatever the angle), one looking through it at the scene."""
    roster, w, cam, tgt = scene
    crowns = torch.nonzero(torch.as_tensor(roster.prim_kind) == 1)[:, 0]  # spheres
    crowns = crowns[torch.as_tensor(roster.prim_params[crowns.numpy(), 0]) > 2.0]
    pos = w["prim_pos"][:, crowns[0]]  # (3, 3): the first crown, per scene
    inside = pos + torch.tensor([0.3, -0.2, 0.5], device=pos.device)
    _check_sweep(roster, w, inside, tgt, camera.intrinsics_from_apertures(12.0, 25.0, 128, 96))


def test_sweep_kernel_refuses_oversize_schedule(scene):
    """A schedule whose rows overflow a block's shared memory raises without
    a launch."""
    roster, w, cam, tgt = scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 64, 48)
    si, sf, radii = sweep_kernel.PixelSweeper(roster, intr).schedule(cam.device)
    before = sweep_kernel.sweep_cuda.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        sweep_kernel.sweep_cuda(si.repeat(6, 1), sf.repeat(6, 1), w, cam,
                                camera.look_at_matrix(cam, tgt), intr, radii.repeat(6))
    assert sweep_kernel.sweep_cuda.launches == before


def _caster_rays(w, cam, tgt, size=(256, 192)):
    """Each frame's pixel rays, then its keypoint segments."""
    intr = camera.intrinsics_from_apertures(12.0, 25.0, *size)
    px = camera.pixel_rays(intr, camera.look_at_matrix(cam, tgt)).reshape(cam.shape[0], -1, 3)
    kp = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"])
    return torch.cat([px, kp.reshape(cam.shape[0], -1, 3) - cam[:, None]], dim=1).contiguous()


@pytest.mark.parametrize("masked", [False, True])
def test_raycast_kernel_matches_plain(scene, masked):
    """csrc/raycast.cu against the plain walks on the same card: every
    packed value of the packed and per-origin modes and the exact mode's
    t, prim and inst bit for bit, its normals within 1e-6; the full roster
    and the hifi tier's masked one, pixel rays, keypoint segments and the
    shadow rays from the hits."""
    roster, w, cam, tgt = scene
    mask = ~meshcast.make_mesh_caster(roster).covered_prims if masked else None
    c = raycast.Raycaster(roster, prim_mask=mask)
    rays = _caster_rays(w, cam, tgt)
    wrappers = (raycast.packed_cuda, raycast.exact_cuda, raycast.multi_cuda)
    before = [f.launches for f in wrappers]
    bits = lambda x: x.view(torch.int32)
    assert torch.equal(bits(c.packed(w, cam, rays)), bits(c.plain_packed(w, cam, rays)))
    e, p = c.cast(w, cam, rays), c.plain_cast(w, cam, rays)
    assert torch.equal(bits(e["t"]), bits(p["t"]))
    assert torch.equal(e["prim"], p["prim"]) and torch.equal(e["inst"], p["inst"])
    assert e["prim"].dtype == torch.int64 and e["inst"].dtype == torch.int32
    assert float(torch.abs(e["normal"] - p["normal"]).max()) <= 1e-6
    hit = torch.isfinite(p["t"])
    assert 0.3 < float(hit.float().mean()) < 1.0
    sun = torch.tensor([0.45, 0.3, 0.84], device=cam.device)
    so = (cam[:, None] + torch.where(hit, p["t"], 0.0)[..., None] * rays + 1e-3 * sun).contiguous()
    sd = sun.expand_as(rays).contiguous()
    assert torch.equal(bits(raycast.multi_cuda(c.kind_table, w, so, sd)),
                       bits(raycast.multi_sweep(c.kind_table, w, so, sd)))
    assert [f.launches for f in wrappers] == [n + 1 for n in before]


@pytest.mark.parametrize("masked", [False, True])
def test_raycast_exclusion_matches_plain(scene, masked):
    """The exact mode with an excluded instance a ray (each segment's own,
    each pixel ray's first hit): t, prim and inst bit-equal to
    ``exact_sweep`` with the same exclusion; ``occlusion_ts`` on CUDA rays
    launches the kernel once and equals its plain version bit for bit."""
    roster, w, cam, tgt = scene
    mask = ~meshcast.make_mesh_caster(roster).covered_prims if masked else None
    c = raycast.Raycaster(roster, prim_mask=mask)
    rays = _caster_rays(w, cam, tgt)
    n_px = 256 * 192  # then each instance's keypoint segments
    first = c.plain_cast(w, cam, rays)["inst"][:, :n_px]
    own = torch.arange(rays.shape[1] - n_px, device=cam.device) // (
        (rays.shape[1] - n_px) // roster.num_instances)
    excl = torch.cat([first, own.to(torch.int32).expand(cam.shape[0], -1)], 1).contiguous()
    k = raycast.exact_cuda(c.kind_table, w, cam, rays, excl)
    t, prim = raycast.exact_sweep(c.kind_table, w, cam, rays, excl)
    hit = t < raycast.INF
    assert torch.equal(k["t"].view(torch.int32),
                       torch.where(hit, t, float("inf")).view(torch.int32))
    assert torch.equal(k["prim"], prim)
    inst = torch.as_tensor(roster.prim_inst, device=cam.device)[torch.clamp_min(prim, 0)]
    assert torch.equal(k["inst"], torch.where(hit, inst, -2).to(torch.int32))
    assert bool(hit.any()) and not bool(hit.all())
    if not masked:
        before = raycast.exact_cuda.launches
        got = raycast.occlusion_ts(w, roster, cam, rays, excl)
        assert raycast.exact_cuda.launches == before + 1
        assert torch.equal(got.view(torch.int32), t.view(torch.int32))


@pytest.mark.parametrize("masked", [False, True])
def test_raycast_kept_rows_cover_the_needed_rows(scene, masked):
    """Each warp of each mode keeps every row that one of its rays needs
    (``raycast.needed_rows``: its half-line meets the row's bounding
    sphere), and far fewer than all on the pixel rays; the kept sets equal
    ``bundle_cull_plain``'s on > 0.99 of the warps."""
    roster, w, cam, tgt = scene
    mask = ~meshcast.make_mesh_caster(roster).covered_prims if masked else None
    c = raycast.Raycaster(roster, prim_mask=mask)
    rays = _caster_rays(w, cam, tgt)
    t = c.plain_cast(w, cam, rays)["t"]
    sun = torch.tensor([0.45, 0.3, 0.84], device=cam.device)
    so = (cam[:, None] + torch.where(torch.isfinite(t), t, 0.0)[..., None] * rays
          + 1e-3 * sun).contiguous()
    sd = sun.expand_as(rays).contiguous()
    for wrapper, table, o, d in ((raycast.packed_cuda, c.packed_table, cam, rays),
                                 (raycast.exact_cuda, c.kind_table, cam, rays),
                                 (raycast.multi_cuda, c.kind_table, so, sd)):
        kept = raycast.kept_buffer(table, d)
        wrapper(table, w, o, d, kept=kept)
        keep = raycast.kept_rows(kept, len(table.rows))
        need = raycast._warps(raycast.needed_rows(table, w, o, d), keep.shape[1]).any(2)
        assert not bool((need & ~keep).any()), wrapper.__name__
        assert bool((keep.sum(-1) >= need.sum(-1)).all())
        mirror = raycast.bundle_cull_plain(table, table.radii_on(cam.device), w, o, d)
        assert (mirror == keep).all(-1).float().mean().item() > 0.99, wrapper.__name__
        if not masked and wrapper is raycast.exact_cuda:
            assert keep.float().mean().item() < 0.25


def test_raycast_exact_tie_resolves_to_the_first_index(scene):
    """The last box made the first box's twin: the kernel names the first
    wherever either is hit, as the plain version's argmin does."""
    roster, w, cam, tgt = scene
    boxes = np.nonzero(np.asarray(roster.prim_kind) == 2)[0]
    i, j = int(boxes[0]), int(boxes[-1])
    wd = {k: v.clone() for k, v in w.items()}
    for k in ("prim_rot", "prim_pos"):
        wd[k][:, j] = wd[k][:, i]
    wd["prim_params"][j] = wd["prim_params"][i]
    g = torch.Generator(device=cam.device).manual_seed(3)
    aim = wd["prim_pos"][:, i, None] + torch.rand(3, 2000, 3, device=cam.device, generator=g) - 0.5
    d = (aim - cam[:, None]).contiguous()
    c = raycast.Raycaster(roster)
    k, p = c.cast(wd, cam, d)["prim"], c.plain_cast(wd, cam, d)["prim"]
    assert torch.equal(k, p) and bool((k == i).any()) and not bool((k == j).any())


def test_raycast_kernel_refuses_oversize_table(scene):
    """A table whose rows overflow a block's shared memory raises without a
    launch."""
    roster, w, cam, tgt = scene
    c = raycast.Raycaster(roster)
    big = raycast.SweepTable([("kind", k, k, np.tile(idx, 6)) for k, idx in c.groups],
                             c.prim_codes, np.asarray(roster.prim_params))
    before = raycast.exact_cuda.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        raycast.exact_cuda(big, w, cam, _caster_rays(w, cam, tgt))
    assert raycast.exact_cuda.launches == before


def test_raycast_kernel_has_no_spills(dev):
    from constructionsceneposeestimation_tpu_torch.utils import kernels
    report = kernels.ptxas_report("raycast.cu")
    assert set(report) == {f"raycast_kernel<{m}>" for m in range(3)}, report
    assert all(r["spill_bytes"] == 0 for r in report.values()), report


MESH_SCENES = {"default": SceneConfig(), "two_dumpers": SceneConfig(n_dumpers=2, n_humans=3)}


@pytest.fixture(scope="module", params=list(MESH_SCENES))
def mesh_scene(dev, request):
    """Four sampled frames of each hifi roster on the card: roster, world,
    cameras, targets."""
    sc = MESH_SCENES[request.param]
    roster = world.make_roster(sc)
    pose, _ = placement.sample_scenes([prng.generator(7, prng.SCENE_STREAM, i)
                                       for i in range(4)], roster, sc, device=dev)
    cam = torch.tensor([[9.0, 4.0, 3.0], [-14.0, 8.0, 6.0], [0.1, 0.1, 25.0], [5.0, -6.0, 1.6]],
                       device=dev)
    tgt = torch.tensor([[0.0, 0.0, 1.5], [2.0, 0.0, 1.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                       device=dev)
    return roster, world.build_world(roster, pose), cam, tgt


def _check_mesh(mesh, w, cam, d):
    """csrc/meshsweep.cu against plain_mesh_sweep on the same terms and rays,
    to the pixel sweep's tolerances; its visits equal ``visited()``, two
    calls are bit-equal, ``packed`` launches it, every walk the layout
    takes (the patch walk on 32 x 32 pixel tiles, the segment walk on any)
    is bit-equal to the split walk, and on layouts that are not a pixel
    grid the segment walk's kept words hold every widened-passing pair and
    match segment_cull_plain's (``_check_segment_kept``). Returns its
    output."""
    m = mesh.mesh_terms(w, cam)
    codes, lay = mesh._on(cam.device)["codes"], mesh.layout(d.shape[1])
    visits = torch.full((cam.shape[0], lay.groups), -1, dtype=torch.int32, device=cam.device)
    sweep = lambda **kw: meshcast.mesh_sweep_cuda(m.terms, m.lo, m.hi, m.spheres, codes, cam, d,
                                                  lay, **kw)
    before = meshcast.mesh_sweep_cuda.launches
    k = sweep(visits=visits)
    again = sweep()
    packed = mesh.packed(w, cam, d)
    assert meshcast.mesh_sweep_cuda.launches == before + 3
    p = meshcast.plain_mesh_sweep(m.terms, m.lo, m.hi, codes, cam, d, lay)
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))
    assert torch.equal(k.view(torch.int32), packed.view(torch.int32))
    assert torch.equal(visits, mesh.visited(w, cam, d).sum(-1).int())
    tiles = lay.grid_w and lay.side == meshcast.PATCH_SIDE
    for walk in meshcast.WALKS:
        if walk == meshcast.PATCH and not tiles:
            continue
        v = torch.full_like(visits, -1)
        assert torch.equal(sweep(visits=v, walk=walk).view(torch.int32), k.view(torch.int32))
        assert torch.equal(v, visits)
    if not lay.grid_w:
        _check_segment_kept(mesh, m, codes, cam, d, lay)
    tk, ck = raycast._unpack(k)
    tp, cp = raycast._unpack(p)
    hk, hp = tk < raycast.INF * 0.99, tp < raycast.INF * 0.99
    assert (hk == hp).float().mean() > 0.9995
    both = hk & hp
    rel = (torch.abs(tk - tp) / tp)[both]
    n = max(int(both.sum()), 1)
    assert int((rel > 2e-4).sum()) / n < 1e-4
    assert int((rel > 1e-5).sum()) / n < 0.005
    assert int((ck[both] != cp[both]).sum()) / n < 1e-3
    return k, visits


def _check_segment_kept(mesh, m, codes, cam, d, lay):
    """The segment walk's ``kept`` words: for every visited block, each
    triangle that some ray of the set passes by the test widened by 8 ulps
    (t > EPS included), no padding triangle, nothing on a block the group
    does not visit; equal to segment_cull_plain's on > 0.99 of the
    (visited block, set) rows."""
    B = cam.shape[0]
    kept = torch.zeros(meshcast.kept_shape(B, lay, mesh.n_blocks), dtype=torch.int32,
                       device=cam.device)
    meshcast.mesh_sweep_cuda(m.terms, m.lo, m.hi, m.spheres, codes, cam, d, lay, kept=kept,
                             walk=meshcast.SEGMENTS)
    mirror = meshcast.segment_cull_plain(m.lo, m.hi, m.spheres, cam, d, lay)
    rays = meshcast.group_rays(d, lay)
    visited = meshcast.block_hits(cam, rays, m.lo, m.hi)
    W, tn = meshcast.block_matrices(m.terms)
    R = lay.rays
    set_of = torch.arange(R, device=cam.device) // meshcast.SET
    triples = torch.nonzero(visited)
    agree = rows = 0
    for c in range(0, triples.shape[0], 32):
        b, g, k = triples[c:c + 32].unbind(1)
        mine = meshcast.kept_triangles(kept[b, g, :, k])  # (V, sets, T)
        need = meshcast.pair_passes(W[b, k], rays[b, g], 8.0, tn[b, k])  # (V, R, T)
        assert not bool((need & ~mine[:, set_of]).any())
        assert not bool((mine & (m.spheres[b, k, 3] < 0)[:, None]).any())
        agree += int((mirror[b, g, :, k] == mine).all(-1).sum())
        rows += mine.shape[0] * mine.shape[1]
    assert rows > 0 and agree / rows > 0.99
    assert int(kept[~visited[:, :, None, :, None].expand_as(kept)].abs().sum()) == 0


@pytest.mark.parametrize("size", [128, 512])
def test_mesh_sweep_kernel_matches_plain(mesh_scene, size):
    """Pixels in 32 x 32 tiles (at 128^2 the groups are too few to fill the
    card, so a CUDA block takes 64 rays of a tile; at 512^2 a whole tile)
    and the keypoint segments, one group a frame, by the segment walk."""
    roster, w, cam, tgt = mesh_scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, size, size)
    mesh = meshcast.make_mesh_caster(roster, grid_hw=(size, size))
    px = camera.pixel_rays(intr, camera.look_at_matrix(cam, tgt)).reshape(4, -1, 3)
    _, visits = _check_mesh(mesh, w, cam, px)
    assert int(visits.sum()) > 0
    kp = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"]).reshape(4, -1, 3)
    _check_mesh(mesh, w, cam, (kp - cam[:, None]).contiguous())


def test_mesh_sweep_camera_inside_a_block(mesh_scene):
    """Cameras at the centre of a block's box (a tree's, in every frame),
    looking through it at the scene."""
    roster, w, cam, tgt = mesh_scene
    mesh = meshcast.make_mesh_caster(roster, grid_hw=(128, 128))
    m = mesh.mesh_terms(w, cam)
    lo, hi = m.lo, m.hi
    k = int(np.nonzero(mesh.codes - 2 == roster.inst_class_names.index("tree"))[0][0])
    inside = 0.5 * (lo[:, k] + hi[:, k])
    assert bool(((inside > lo[:, k]) & (inside < hi[:, k])).all())
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 128, 128)
    px = camera.pixel_rays(intr, camera.look_at_matrix(inside, tgt)).reshape(4, -1, 3)
    _check_mesh(mesh, w, inside, px)


def test_mesh_sweep_with_no_visit_leaves_inf(mesh_scene):
    """Cameras 200 m up looking up: no group meets a box, and every ray keeps
    raycast.INF, bit for bit."""
    roster, w, cam, _ = mesh_scene
    mesh = meshcast.make_mesh_caster(roster, grid_hw=(128, 128))
    up = cam + torch.tensor([0.0, 0.0, 200.0], device=cam.device)
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 128, 128)
    px = camera.pixel_rays(intr, camera.look_at_matrix(up, up + torch.tensor(
        [0.1, 0.0, 10.0], device=cam.device))).reshape(4, -1, 3)
    out, visits = _check_mesh(mesh, w, up, px)
    assert int(visits.abs().sum()) == 0
    inf = torch.tensor(raycast.INF, device=cam.device).view(torch.int32)
    assert bool((out.view(torch.int32) == inf).all())


def test_mesh_sweep_one_group_of_many_rays(mesh_scene):
    """1500 rays a frame, which 1024 does not divide: one group, which a
    CUDA block's slab test walks in chunks."""
    roster, w, cam, _ = mesh_scene
    mesh = meshcast.make_mesh_caster(roster)
    gen = torch.Generator().manual_seed(3)
    aim = (torch.rand(4, 1500, 3, generator=gen) - 0.5) * torch.tensor([30.0, 30.0, 8.0])
    d = (aim.to(cam.device) + torch.tensor([0.0, 0.0, 2.0], device=cam.device)
         - cam[:, None]).contiguous()
    assert mesh.layout(1500) == meshcast.RayLayout(1, 1500, 0, 32)
    _check_mesh(mesh, w, cam, d)


@pytest.mark.parametrize("size", [128, 512])
def test_mesh_sweep_kept_covers_the_passing_pairs(mesh_scene, size):
    """The patch walk's ``kept`` words hold, for every visited block, each
    triangle that some ray of the patch passes by the test widened by 8
    ulps, and no padding triangle; they equal patch_cull_plain's on > 0.99
    of the (visited block, patch) rows."""
    roster, w, cam, tgt = mesh_scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, size, size)
    mesh = meshcast.make_mesh_caster(roster, grid_hw=(size, size))
    d = camera.pixel_rays(intr, camera.look_at_matrix(cam, tgt)).reshape(4, -1, 3)
    m = mesh.mesh_terms(w, cam)
    codes, lay = mesh._on(cam.device)["codes"], mesh.layout(d.shape[1])
    kept = torch.zeros(meshcast.kept_shape(4, lay, mesh.n_blocks), dtype=torch.int32,
                       device=cam.device)
    meshcast.mesh_sweep_cuda(m.terms, m.lo, m.hi, m.spheres, codes, cam, d, lay, kept=kept,
                             walk=meshcast.PATCH)
    visited = mesh.visited(w, cam, d)
    _, mirror = meshcast.patch_cull_plain(m.lo, m.hi, m.spheres, cam, d, lay)
    W, _ = meshcast.block_matrices(m.terms)
    rays = meshcast.group_rays(d, lay)
    triples = torch.nonzero(visited)
    agree = rows = 0
    for c in range(0, triples.shape[0], 32):
        b, g, k = triples[c:c + 32].unbind(1)
        mine = meshcast.kept_triangles(kept[b, g, :, k])
        need = meshcast.patch_passes(W[b, k], rays[b, g], widen=8.0)
        assert not bool((need & ~mine).any())
        assert not bool((mine & (m.spheres[b, k, 3] < 0)[:, None]).any())
        agree += int((mirror[b, g, :, k] == mine).all(-1).sum())
        rows += mine.shape[0] * mine.shape[1]
    assert rows > 0 and agree / rows > 0.99
    assert int(kept[~visited[:, :, None, :, None].expand_as(kept)].abs().sum()) == 0


def test_mesh_terms_kernel_matches_plain(mesh_scene):
    """csrc/meshterms.cu (through ``MeshCaster.mesh_terms``) against
    ``plain_mesh_terms`` on the same world and origin: each part within
    8 units of ``terms_gap`` (a few ulps of the corners' scale times the
    part's derivative: einsum and FMA chains round the corners apart), and
    bit for bit where both are exact: cr = 0 and radius -1 on the same
    slots."""
    roster, w, cam, _ = mesh_scene
    mesh = meshcast.make_mesh_caster(roster)
    before = meshcast.mesh_terms_cuda.launches, meshcast.plain_mesh_terms.card_calls
    m = mesh.mesh_terms(w, cam)
    assert meshcast.mesh_terms_cuda.launches == before[0] + 1 and m.origin is cam
    ref = meshcast.plain_mesh_terms(mesh, w, cam)
    assert meshcast.plain_mesh_terms.card_calls == before[1] + 1
    gap = meshcast.terms_gap(m, ref, mesh.corners(w))
    assert max(gap.values()) <= 8.0, gap
    flat, want = ((x.terms[:, :, :3] == 0).all(2) for x in (m, ref))
    assert torch.equal(flat, want) and bool(want.any())
    assert torch.equal(m.spheres[:, :, 3][want], ref.spheres[:, :, 3][want])
    assert bool((m.spheres[:, :, 3][~want] > 0).all())
    for got in m[:4]:
        assert got.is_contiguous() and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("size", [128, 512])
def test_mesh_sweep_over_kernel_terms_matches_plain_terms(mesh_scene, size):
    """The mesh sweep kernel over csrc/meshterms.cu's terms against the same
    kernel over ``plain_mesh_terms``', pixels and keypoint segments, to the
    bars of ``_check_mesh``."""
    roster, w, cam, tgt = mesh_scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, size, size)
    mesh = meshcast.make_mesh_caster(roster, grid_hw=(size, size))
    px = camera.pixel_rays(intr, camera.look_at_matrix(cam, tgt)).reshape(4, -1, 3)
    kp = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"]).reshape(4, -1, 3)
    terms = mesh.mesh_terms(w, cam), meshcast.plain_mesh_terms(mesh, w, cam)
    codes = mesh._on(cam.device)["codes"]
    for d in (px, (kp - cam[:, None]).contiguous()):
        lay = mesh.layout(d.shape[1])
        k, p = (meshcast.mesh_sweep_cuda(m.terms, m.lo, m.hi, m.spheres, codes, cam, d, lay)
                for m in terms)
        tk, ck = raycast._unpack(k)
        tp, cp = raycast._unpack(p)
        hk, hp = tk < raycast.INF * 0.99, tp < raycast.INF * 0.99
        both = hk & hp
        assert (hk == hp).float().mean() > 0.9995 and int(both.sum()) > 0
        rel = (torch.abs(tk - tp) / tp)[both]
        n = int(both.sum())
        assert int((rel > 2e-4).sum()) / n < 1e-4
        assert int((rel > 1e-5).sum()) / n < 0.005
        assert int((ck[both] != cp[both]).sum()) / n < 1e-3


def test_mesh_terms_kernel_has_no_spills(dev):
    from constructionsceneposeestimation_tpu_torch.utils import kernels
    report = kernels.ptxas_report("meshterms.cu")
    assert set(report) == {"mesh_terms_kernel"}, report
    assert all(r["spill_bytes"] == 0 for r in report.values()), report


def test_mesh_sweep_kernel_has_no_spills(dev):
    from constructionsceneposeestimation_tpu_torch.utils import kernels
    report = kernels.ptxas_report("meshsweep.cu")
    assert set(report) == {"mesh_sweep_kernel<64, 1, 4>", "mesh_sweep_patch_kernel",
                           "mesh_sweep_segment_kernel"}, report
    assert all(r["spill_bytes"] == 0 and r["registers"] <= 80 for r in report.values()), report


def _rgb_pair(roster, w, cam, tgt, width, height, noise, texels=None):
    """The kernel's and the plain version's images of the frames seen from
    cam (textured with ``texels``), the instance map, and the ground pixels
    within an AO row's reach."""
    intr = camera.intrinsics_from_apertures(12.0, 25.0, width, height)
    M = camera.look_at_matrix(cam, tgt)
    B = cam.shape[0]
    t, code = raycast._unpack(sweep_kernel.PixelSweeper(roster, intr)(w, cam, M))
    t = torch.where(t < raycast.INF * 0.99, t, float("inf")).reshape(B, height, width)
    inst = (code - 2).reshape(B, height, width).to(torch.int32)
    depth = t * torch.sum(camera.pixel_rays(intr, M) * (-M[:, :, 0])[:, None, None], -1)
    t = torch.where(depth >= 250.0, float("inf"), t).contiguous()
    inst = torch.where(torch.isfinite(t), inst, -2).to(torch.int32).contiguous()
    from constructionsceneposeestimation_tpu_torch.render.shading import default_lighting
    lit = default_lighting(B, cam.device)
    if not noise:
        lit = lit._replace(tex_strength=torch.zeros(B, device=cam.device))
    args = (t, inst, rgb_kernel.instance_table(roster, w["inst_rot"], w["inst_pos"]),
            rgb_kernel.ao_table(roster, w["inst_pos"]), rgb_kernel.rgb_params(M, cam, intr, lit))
    before = (rgb_kernel.rgb_cuda.launches, rgb_kernel.rgb_cuda.textured_launches)
    a = rgb_kernel.fused_rgb(*args, texels).float()
    textured = texels is not None
    assert (rgb_kernel.rgb_cuda.launches, rgb_kernel.rgb_cuda.textured_launches) == (
        before[0] + (not textured), before[1] + textured)
    b = rgb_kernel.plain_rgb(*args, texels).float()
    reach = rgb_kernel.ao_rows_needed(t, inst, args[3], args[4]) > 0
    torch.cuda.synchronize()
    return a, b, inst, reach


def _check_rgb(a, b, inst, reach, noise, with_sky=True):
    """The RGB tolerances; frames looking straight down show no sky. With
    the noise off, |d| <= 1 u8 on all but 1e-3 of the ground pixels within
    an AO row's reach, where a row the kernel's cull wrongly dropped would
    show."""
    if noise:
        assert abs(a.mean() - b.mean()) < 1.0 and abs(a.std() - b.std()) < 2.0
    else:
        d = torch.abs(a - b)
        assert d.mean() < 0.5 and (d > 1).float().mean() < 0.02
        sky = inst == -2
        assert bool(sky.any()) == with_sky and torch.equal(a[sky], b[sky])
        assert bool(reach.any()) and (d.amax(-1)[reach] > 1).float().mean() <= 1e-3


@pytest.mark.parametrize("noise", [False, True])
def test_rgb_kernel_matches_plain(scene, noise):
    roster, w, cam, tgt = scene
    a, b, inst, reach = _rgb_pair(roster, w, cam, tgt, 128, 96, noise)
    _check_rgb(a, b, inst, reach, noise)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("view", ["horizon", "nadir"])
def test_rgb_kernel_ragged_tiles(scene, view, noise):
    """250 x 190: ragged tiles at the right and bottom edges, a halo at the
    tile and the frame edges, rows not 16-byte aligned (3-byte stores);
    cameras at the horizon (ground cells spanning far distances: the AO
    cull keeps many rows) and looking straight down."""
    roster, w, _, _ = scene
    cams = {"horizon": ([[0.0, -30.0, 1.6], [25.0, 5.0, 1.2], [-20.0, -20.0, 2.0]],
                        [[0.0, 60.0, 1.6], [-60.0, 0.0, 1.2], [40.0, 40.0, 1.8]]),
            "nadir": ([[0.1, 0.1, 25.0], [3.0, -2.0, 12.0], [-4.0, 5.0, 40.0]],
                      [[0.0, 0.0, 0.0], [3.0, -2.01, 0.0], [-4.0, 5.01, 0.0]])}[view]
    cam, tgt = (torch.tensor(c, device=w["inst_pos"].device) for c in cams)
    a, b, inst, reach = _rgb_pair(roster, w, cam, tgt, 250, 190, noise)
    _check_rgb(a, b, inst, reach, noise, with_sky=view == "horizon")


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("view", ["worker", "horizon"])
def test_rgb_textured_variant_matches_plain(scene, view, noise):
    """The textured variant against the plain textured version: close
    views of the worker and the dumper (every garment band, the crown, the
    grime) at 128 x 96, and the horizon views at 250 x 190 (ragged tiles,
    far ground). With the noise off, the tolerances of ``_check_rgb``, and
    |d| > 2 u8 on at most 1e-3 more of the values than the untextured
    kernel against its plain version on the same inputs (which shows such
    pixels at silhouettes and pattern edges): a texel lookup whose u or v
    sits on a bin edge may take the neighbouring texel when the kernel's
    local coordinates differ from the plain version's by an ulp."""
    roster, w, _, _ = scene
    from constructionsceneposeestimation_tpu_torch.render import textures
    texels = textures.dense_table(textures.load_factors()).to(w["inst_pos"].device)
    human, dumper = (w["inst_pos"][:, s[0]] for s in (roster.human_slice, roster.dumper_slice))
    if view == "worker":
        tgt = torch.stack([human[0], dumper[1], human[2]]) + torch.tensor(
            [0.0, 0.0, 1.0], device=human.device)
        cam = tgt + torch.tensor([[3.0, -2.0, 0.6], [5.0, 3.0, 1.5], [-2.5, 0.5, 0.2]],
                                 device=human.device)
        size = (128, 96)
    else:
        cam = torch.tensor([[0.0, -30.0, 1.6], [25.0, 5.0, 1.2], [-20.0, -20.0, 2.0]],
                           device=human.device)
        tgt = torch.tensor([[0.0, 60.0, 1.6], [-60.0, 0.0, 1.2], [40.0, 40.0, 1.8]],
                           device=human.device)
        size = (250, 190)
    a, b, inst, reach = _rgb_pair(roster, w, cam, tgt, *size, noise, texels)
    _check_rgb(a, b, inst, reach, noise)
    if not noise:
        a0, b0, _, _ = _rgb_pair(roster, w, cam, tgt, *size, noise)
        far = lambda x, y: (torch.abs(x - y) > 2).float().mean().item()
        assert far(a, b) <= far(a0, b0) + 1e-3, (far(a, b), far(a0, b0))


def _tier_inputs(roster, w, cam, tgt, width, height, noise):
    """The RGB inputs of the analytic-normal and sun-shadow tiers as
    ``annotate.render_frame`` builds them on the card: the exact caster's t,
    instance and normals, the shadow rays' t."""
    intr = camera.intrinsics_from_apertures(12.0, 25.0, width, height)
    M = camera.look_at_matrix(cam, tgt)
    B = cam.shape[0]
    caster = raycast.Raycaster(roster)
    rd = camera.pixel_rays(intr, M)
    hit = caster.cast(w, cam, rd.reshape(B, -1, 3))
    t = hit["t"].reshape(B, height, width)
    depth = t * torch.sum(rd * (-M[:, :, 0])[:, None, None], -1)
    t = torch.where(depth >= 250.0, float("inf"), t).contiguous()
    inst = torch.where(torch.isfinite(t), hit["inst"].reshape(B, height, width),
                       -2).to(torch.int32).contiguous()
    from constructionsceneposeestimation_tpu_torch.render.shading import default_lighting
    lit = default_lighting(B, cam.device)
    if not noise:
        lit = lit._replace(tex_strength=torch.zeros(B, device=cam.device))
    sun = -lit.sun_dir
    p_hit = cam[:, None, None] + torch.where(torch.isfinite(t), t, 0.0)[..., None] * rd
    shadow = caster.fast_multi_origin(
        w, (p_hit + (sun * 1e-3)[:, None, None]).reshape(B, -1, 3),
        sun[:, None].expand(B, height * width, 3))["t"].reshape(B, height, width).contiguous()
    args = (t, inst, rgb_kernel.instance_table(roster, w["inst_rot"], w["inst_pos"]),
            rgb_kernel.ao_table(roster, w["inst_pos"]), rgb_kernel.rgb_params(M, cam, intr, lit))
    return args, hit["normal"].reshape(B, height, width, 3).contiguous(), shadow


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("variant", list(rgb_kernel.VARIANTS))
def test_rgb_tier_variant_matches_plain(scene, variant, noise):
    """Each tier variant of the RGB kernel (analytic normals, sun shadows,
    the flat albedo, their combinations, textured where not flat) against
    its plain version on the same inputs, at 250 x 190 (ragged tiles), to
    the tolerances of ``_check_rgb``; the launch is counted as its variant's
    alone. A shadowed pixel is one the kernel and the plain version both
    gate, from the same ``shadow_t``."""
    roster, w, cam, tgt = scene
    args, normal, shadow = _tier_inputs(roster, w, cam, tgt, 250, 190, noise)
    parts = variant.split("+")
    texels = None
    if "textured" in parts:
        from constructionsceneposeestimation_tpu_torch.render import textures
        texels = textures.dense_table(textures.load_factors()).to(cam.device)
    kw = dict(normal=normal if "normal" in parts else None,
              shadow_t=shadow if "shadow" in parts else None, procedural="flat" not in parts)
    before = (rgb_kernel.rgb_cuda.launches, rgb_kernel.rgb_cuda.textured_launches,
              dict(rgb_kernel.rgb_cuda.tier_launches))
    a = rgb_kernel.fused_rgb(*args, texels, **kw).float()
    after = dict(before[2], **{variant: before[2][variant] + 1})
    assert (rgb_kernel.rgb_cuda.launches, rgb_kernel.rgb_cuda.textured_launches,
            rgb_kernel.rgb_cuda.tier_launches) == (before[0], before[1], after)
    b = rgb_kernel.plain_rgb(*args, texels, **kw).float()
    reach = rgb_kernel.ao_rows_needed(args[0], args[1], args[3], args[4]) > 0
    torch.cuda.synchronize()
    _check_rgb(a, b, args[1], reach, noise)
    if "shadow" in parts and not noise:
        unlit = (shadow < 1e9) & torch.isfinite(args[0])
        assert 0.01 < unlit.float().mean().item() < 0.9
        kw0 = dict(kw, shadow_t=None)
        a0 = rgb_kernel.fused_rgb(*args, texels, **kw0).float()
        b0 = rgb_kernel.plain_rgb(*args, texels, **kw0).float()
        for x, x0 in ((a, a0), (b, b0)):
            changed = (x != x0).any(-1)
            assert not bool((changed & ~unlit).any())


def test_rgb_default_kernel_keeps_its_registers(dev):
    """The default instantiation keeps 32 registers and no spills beside
    its tier variants (ptxas's report of csrc/rgb.cu); each variant stays
    within its launch bounds' cap (8 blocks an SM for the textured ones: 32
    registers), and the textured ones spill at most the 40 bytes of stores
    measured when their cap was chosen."""
    from constructionsceneposeestimation_tpu_torch.utils import kernels
    report = kernels.ptxas_report("rgb.cu")
    assert report["rgb_kernel<false, 0>"] == {"registers": 32, "spill_bytes": 0}
    for tex in (False, True):
        for tier in range(8):
            if tex and tier & rgb_kernel.TIER_FLAT:
                continue
            r = report[f"rgb_kernel<{str(tex).lower()}, {tier}>"]
            assert r["registers"] <= (32 if tex else 40), (tex, tier)
            if tex:
                assert r["spill_bytes"] <= 40, tier


def test_rgb_tier_refuses_missing_planes(scene):
    """A tier without its plane is refused by the entry point, launching
    nothing."""
    roster, w, cam, tgt = scene
    args, normal, shadow = _tier_inputs(roster, w, cam, tgt, 64, 48, False)
    from constructionsceneposeestimation_tpu_torch.utils import kernels
    out = torch.empty(*args[0].shape, 3, dtype=torch.uint8, device=cam.device)
    B, h, wd = args[0].shape
    with pytest.raises(RuntimeError, match="do not fit"):
        kernels.launch("cspe_rgb_tier", args[0], args[1], args[2], args[2].shape[1], args[3],
                       args[3].shape[1], args[4], None, None, None, rgb_kernel.TIER_NORMAL, B, h,
                       wd, out)


def test_rgb_kernel_refuses_oversize_table(scene):
    """An 800-row instance table overflows a block's shared memory: the
    kernel refuses it without a launch."""
    roster, w, cam, tgt = scene
    intr = camera.intrinsics_from_apertures(12.0, 25.0, 64, 48)
    M = camera.look_at_matrix(cam, tgt)
    table = rgb_kernel.instance_table(roster, w["inst_rot"], w["inst_pos"])
    table = torch.cat([table[:, :-2].repeat(1, 20, 1), table[:, -2:]], dim=1)[:, -800:]
    t = torch.full((3, 48, 64), float("inf"), device=cam.device)
    inst = torch.full((3, 48, 64), -2, dtype=torch.int32, device=cam.device)
    from constructionsceneposeestimation_tpu_torch.render.shading import default_lighting
    par = rgb_kernel.rgb_params(M, cam, intr, default_lighting(3, cam.device))
    before = rgb_kernel.rgb_cuda.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        rgb_kernel.rgb_cuda(t, inst, table.contiguous(),
                            rgb_kernel.ao_table(roster, w["inst_pos"]), par)
    assert rgb_kernel.rgb_cuda.launches == before


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


def _heatmap_case(dev, case):
    """(uv, channel, visible, C, h, w) of one adversarial heatmap case."""
    rng = np.random.RandomState(len(case))
    B, n, C, h, w = {"odd (3, 5, 37, 61)": (3, 41, 5, 37, 61),
                     "width 130": (2, 680, 71, 130, 130),
                     "width 192": (2, 680, 71, 192, 192)}.get(case, (2, 680, 71, 128, 128))
    uv = rng.uniform(-10, 4 * w + 10, (B, n, 2))
    ch = rng.randint(0, C, (B, n))
    vis = rng.rand(B, n) > 0.5
    if case == "all invisible":
        vis[:] = False
    elif case == "680 on one channel":
        ch[:] = 3
        vis[:] = True
    elif case == "off the map":
        side = rng.rand(B, n, 2) > 0.5
        uv = np.where(side, rng.uniform(-120, -1, (B, n, 2)), rng.uniform(4 * w + 1, 4 * w + 120,
                                                                           (B, n, 2)))
    t = lambda x, dt: torch.tensor(x, dtype=dt, device=dev)
    return t(uv, torch.float32), t(ch, torch.int32), t(vis, torch.bool), C, h, w


@pytest.mark.parametrize("case", ["odd (3, 5, 37, 61)", "width 130", "width 192",
                                  "all invisible", "680 on one channel", "off the map"])
def test_heatmap_kernel_adversarial(dev, case):
    """Odd map sizes and N % 4 != 0 (scalar slot loads), a row pitch that
    is not 16-byte aligned (width 130), 192^2 maps, no visible keypoint,
    every slot visible on one channel, keypoints off the map."""
    uv, ch, vis, C, h, w = _heatmap_case(dev, case)
    before = heatmap.heatmap_cuda.launches
    a = heatmap.heatmaps(uv, ch, vis, C, h, w, 2.0, 4)
    assert heatmap.heatmap_cuda.launches == before + 1
    b = heatmap.render_heatmaps(uv, ch, vis, C, h, w, 2.0, 4)
    torch.cuda.synchronize()
    assert a.shape == (uv.shape[0], C, h, w)
    assert torch.abs(a - b).max() < 2e-4
    if case == "all invisible":
        assert not bool(a.any())
    if case == "off the map":
        assert bool((b > 0).any())  # tails of keypoints just off the map


def test_heatmap_kernel_refuses_oversize_slots(dev):
    """7000 keypoint slots (56 KB of keypoints) overflow a block's shared
    memory: the kernel refuses them without a launch."""
    B, n = 2, 7000
    uv = torch.zeros(B, n, 2, device=dev)
    ch = torch.zeros(B, n, dtype=torch.int32, device=dev)
    vis = torch.ones(B, n, dtype=torch.bool, device=dev)
    before = heatmap.heatmap_cuda.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        heatmap.heatmap_cuda(uv, ch, vis, 71, 128, 128, 2.0, 4)
    assert heatmap.heatmap_cuda.launches == before


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


@pytest.mark.parametrize("mode", ["hifi", "clip"])
def test_hifi_and_clip_batches_on_cuda_match_cpu(dev, mode):
    """A hifi batch (the masked sweep kernel merged with the triangle sweep)
    and a batch of clips of 3 straddling a clip boundary, card against CPU,
    to the tolerances of the i.i.d. batch; hifi labels bit-equal to the
    proxy's on the card."""
    cfg = Config(pipeline=PipelineConfig(render_width=128, render_height=128, batch_size=4))
    hifi = mode == "hifi"
    fns = {where: (Pipeline(cfg, device=where, hifi_mesh=hifi).make_generate_fn() if hifi
                   else Pipeline(cfg, device=where).make_sequence_fn(3))
           for where in (dev, "cpu")}
    before = sweep_kernel.sweep_cuda.launches
    mesh_before = meshcast.mesh_sweep_cuda.launches
    g = fns[dev](3, range(1, 5))
    assert sweep_kernel.sweep_cuda.launches == before + 1
    # The hifi batch's triangle sweep: pixels and keypoint segments.
    assert meshcast.mesh_sweep_cuda.launches == mesh_before + (2 if hifi else 0)
    c = fns["cpu"](3, range(1, 5))
    assert (g.instance.cpu() == c.instance).float().mean() > 0.999
    fin = torch.isfinite(g.depth.cpu()) & torch.isfinite(c.depth)
    assert (torch.isfinite(g.depth.cpu()) == torch.isfinite(c.depth)).float().mean() > 0.999
    assert torch.allclose(g.depth.cpu()[fin], c.depth[fin], rtol=3e-4)
    assert torch.allclose(g.center.cpu(), c.center, atol=1e-4)
    assert torch.allclose(g.kpt_uv.cpu(), c.kpt_uv, atol=1e-3)
    assert (g.kpt_visible.cpu() == c.kpt_visible).float().mean() >= 0.99
    if hifi:
        proxy = Pipeline(cfg, device=dev).make_generate_fn()(3, range(1, 5))
        for f in ("center", "size", "euler_deg"):
            assert torch.equal(getattr(g, f), getattr(proxy, f)), f


@pytest.mark.parametrize("shape", [(2, 71, 128, 128), (3, 5, 37, 61), (7, 3, 3), (1, 192, 192),
                                   (1, 3, 300, 517)])
def test_peak_kernel_matches_plain(dev, shape):
    """Blobs, noise with negative values, an odd shape and N = 15 maps,
    3 x 3 maps, and maps of several 128-column strips (192^2, 300 x 517)."""
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


@pytest.mark.parametrize("kind", ["constant", "plateau", "all_negative", "all_zero"])
@pytest.mark.parametrize("k", [8, 100])
def test_peak_kernel_adversarial_maps(dev, kind, k):
    """Every pixel a survivor, flat-topped blobs (ties broken by flat index),
    nothing positive; K = 100 overflows a warp's buffer of NMS survivors
    on the plateaus."""
    rng = np.random.RandomState(len(kind))
    shape = (4, 3, 128, 128)
    if kind == "constant":
        x = np.full(shape, 0.7, np.float32)
    elif kind == "plateau":
        yy, xx = np.mgrid[:128, :128]
        x = np.zeros(shape, np.float32)
        for idx in np.ndindex(shape[:2]):
            for _ in range(6):
                cy, cx = rng.uniform(0, 128), rng.uniform(0, 128)
                x[idx] += 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 32.0)
        x = np.minimum(x, 1.0)
    elif kind == "all_negative":
        x = -rng.rand(*shape).astype(np.float32) - 0.01
    else:
        x = np.zeros(shape, np.float32)
    hm = torch.tensor(x, device=dev)
    uv, sc = peak_kernel.peaks_cuda(hm, k)
    uv_p, sc_p = peak_kernel.extract_peaks_plain(hm, k)
    torch.cuda.synchronize()
    assert torch.equal(sc, sc_p)
    assert torch.abs(uv - uv_p).max() <= 1e-3


def test_peak_kernel_refuses_bad_shapes(dev):
    """Maps below 3 x 3 and K outside [1, 512] raise without a launch; it
    never falls back to the plain version."""
    before = peak_kernel.peaks_cuda.launches
    with pytest.raises(ValueError, match="3 x 3"):
        peak_kernel.peaks_cuda(torch.zeros(1, 2, 16, device=dev))
    with pytest.raises(ValueError, match="max_peaks"):
        peak_kernel.peaks_cuda(torch.zeros(1, 16, 16, device=dev), 513)
    assert peak_kernel.peaks_cuda.launches == before


def test_training_step_on_cuda_matches_cpu(dev):
    """``train_on_batch`` on the card against the plain CPU path from the
    same state (the full-width backbone in f32, 2 frames of 128^2 with the
    same augment draws): the loss to 1e-3 relative and each gradient to 1e-2
    of its norm, over two steps (the first has lr 0, the second moves the
    weights: fused AdamW on the card, the single-tensor one on the CPU)."""
    from constructionsceneposeestimation_tpu_torch.config import TrainConfig
    from constructionsceneposeestimation_tpu_torch.models import pose_net
    from constructionsceneposeestimation_tpu_torch.ops import preprocess
    from constructionsceneposeestimation_tpu_torch.train import loop

    cfg = Config(pipeline=PipelineConfig(render_width=128, render_height=128),
                 train=TrainConfig(batch_size=2, steps=10, warmup_steps=1, loss="focal"))
    batch = Pipeline(cfg, device="cpu").make_generate_fn(camera_mix=0.3)(0, range(2))
    draws = preprocess.augment_draws(0, range(2), 128, 128)
    runs = {}
    for where in (dev, torch.device("cpu")):
        state = loop.create_train_state(cfg, pose_net.make_model(device=where,
                                                                 dtype=torch.float32))
        bs = loop.BatchStep(cfg, world.make_roster(cfg.scene))
        b = FrameBatch(*(v.to(where) for v in batch))
        d = preprocess.AugmentDraws(*(v.to(where) for v in draws))
        runs[where.type] = []
        for _ in range(2):
            loss = bs.forward_backward(state, b, d).item()
            runs[where.type].append((loss, {n: p.grad.cpu() for n, p in
                                            state.model.named_parameters()}))
            bs.update(state)
    for (lc, gc), (lp, gp) in zip(runs["cuda"], runs["cpu"]):
        assert abs(lc - lp) <= 1e-3 * abs(lp)
        for n, g in gp.items():
            assert torch.linalg.norm(gc[n] - g) <= 1e-2 * torch.linalg.norm(g), n


def test_host_copy_equals_cpu(dev):
    """``HostCopy`` of a card batch: pinned host buffers filled on a copy
    stream of their own, bit-equal to ``.cpu()`` of each field, dtypes and
    shapes kept, with the heatmaps left out (zero channels) too; the copy
    of batch i is already queued when batch i+1 is generated."""
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import HostCopy

    cfg = Config(scene=SceneConfig(n_cones=2, n_trees=1, n_fence_panels=4),
                 pipeline=PipelineConfig(render_width=128, render_height=128))
    pipe = Pipeline(cfg, device=dev)
    for hms in (True, False):
        gen = pipe.make_generate_fn(include_heatmaps=hms)
        first = gen(0, range(4))
        copy = HostCopy(first)
        second = gen(0, range(4, 8))  # queued behind the copy, not before it
        host = copy.wait()
        for name, h, v in zip(FrameBatch._fields, host, first):
            assert isinstance(h, np.ndarray), name
            ref = v.cpu().numpy()
            assert h.dtype == ref.dtype and h.shape == ref.shape, name
            np.testing.assert_array_equal(h, ref, err_msg=name)
        assert all(t.is_pinned() for t in copy._host if t.numel() > 0)
        assert not torch.equal(second.rgb, first.rgb)


@pytest.mark.parametrize("shape,stride", [((32, 10, 32, 32), 4), ((128, 28, 96, 96), 2)])
def test_heatmap_kernel_at_the_crop_shapes(dev, shape, stride):
    """The crop targets' shapes: the dumper's (crop 128, stride 4) and the
    crane's per-part crops (crop 192, stride 2), keypoint k on channel k,
    some outside the crop, sigma 1.5."""
    N, C, h, w = shape
    rng = np.random.RandomState(C)
    uv = torch.tensor(rng.uniform(-10, w * stride + 10, (N, C, 2)), dtype=torch.float32,
                      device=dev)
    ch = torch.arange(C, dtype=torch.int32, device=dev).expand(N, C).contiguous()
    vis = torch.tensor(rng.rand(N, C) > 0.4, device=dev)
    before = heatmap.heatmap_cuda.launches
    a = heatmap.heatmaps(uv, ch, vis, C, h, w, 1.5, stride)
    assert heatmap.heatmap_cuda.launches == before + 1
    b = heatmap.render_heatmaps(uv, ch, vis, C, h, w, 1.5, stride)
    torch.cuda.synchronize()
    assert torch.abs(a - b).max() < 2e-4


def test_two_stage_on_cuda_matches_cpu(dev):
    """One crop step (the dumper, crop 128) and one detector step (stride 2)
    on the card against the plain CPU path, full-width nets in f32, 4
    ladder frames of 128^2 (views 4 and 5 show the dumper), the same draws:
    loss to 1e-3 relative, each gradient to 1e-2 of its norm; the infer
    function's boxes and scores to 1e-3 (its crane net on per-part crops of
    96^2). These are chip_smoke.py's inputs: on 2 of these frames the
    detector's deepest GroupNorms see 4 x 4 maps and its gradients part by
    2% of a norm, the per-part crops of 128^2 frames lie mostly off the
    frame, and GroupNorm over their constant regions leaves their gradients
    to rounding."""
    from constructionsceneposeestimation_tpu_torch import cli
    from constructionsceneposeestimation_tpu_torch.ops import preprocess
    from constructionsceneposeestimation_tpu_torch.train import crop_loop, detect_loop
    from constructionsceneposeestimation_tpu_torch.train import loop

    cfg = Config(pipeline=PipelineConfig(render_width=128, render_height=128))
    host = Pipeline(cfg, device="cpu")
    batch = host.make_generate_fn(ladder=True, include_heatmaps=False)(0, range(4, 8))
    crops = crop_loop.crop_draws(0, range(4, 8), 1, 128)
    aug = preprocess.augment_draws(0, range(4, 8), 128, 128)
    runs = {}
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        b = FrameBatch(*(v.to(where) for v in batch))
        model = crop_loop.make_crop_model("dumper", device=where, dtype=torch.float32)
        state = crop_loop.create_crop_train_state(cfg, model)
        step = crop_loop.CropTrainStep(cfg, model, Pipeline(cfg, device=where), "dumper", 128)
        draws = crop_loop.CropDraws(crops.jitter.to(where), preprocess.AugmentDraws(
            *(v.to(where) for v in crops.augment)))
        loss = step.forward_backward(state, *step.crops(b, draws)).item()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        det = detect_loop.make_detect_model(output_stride=2, device=where, dtype=torch.float32)
        dloss = detect_loop.DetectBatchStep(cfg, det, host.roster).forward_backward(
            loop.create_train_state(cfg, det), b.rgb, b,
            preprocess.AugmentDraws(*(v.to(where) for v in aug))).item()
        dgrads = {n: p.grad.cpu() for n, p in det.named_parameters()}
        crane = crop_loop.make_crop_model("crane", roster=host.roster, output_stride=2,
                                          device=where, dtype=torch.float32)
        out = cli.make_infer_fn(det.eval(), model.eval(), 128, host.intr, host.roster, 4,
                                crane.eval(), 96)(b.rgb, b.camera_pose7)
        runs[tag] = (loss, grads, dloss, dgrads, {k: v.cpu() for k, v in out.items()})
    (l_d, g_d, dl_d, dg_d, o_d), (l_c, g_c, dl_c, dg_c, o_c) = runs["card"], runs["cpu"]
    for a, b_, ga, gb in ((l_d, l_c, g_d, g_c), (dl_d, dl_c, dg_d, dg_c)):
        assert abs(a - b_) <= 1e-3 * abs(b_)
        for n, g in gb.items():
            assert torch.linalg.norm(ga[n] - g) <= 1e-2 * torch.linalg.norm(g), n
    assert torch.abs(o_d["boxes"] - o_c["boxes"]).max() < 1e-3
    assert torch.abs(o_d["scores"] - o_c["scores"]).max() < 1e-3


def test_chained_ms_times_a_chain_on_the_card(dev):
    """``profiling.chained_ms`` on the card: a chain of matmuls, each fed
    the previous result, takes about as long per step as the same matmul
    timed alone, and 4 times the work takes longer."""
    from constructionsceneposeestimation_tpu_torch.utils import profiling
    x = torch.randn(2048, 2048, device=dev)

    def step(acc, x, k):
        y = x + acc
        for _ in range(k):
            y = y @ x * 1e-3
        return y[0, 0]

    one = profiling.chained_ms(step, n=8, args=(x, 1), device=dev)
    four = profiling.chained_ms(step, n=8, args=(x, 4), device=dev)
    assert 0.0 < one < four
