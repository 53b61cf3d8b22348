"""The mesh sweep kernel's culls, on the CPU, through their mirrors
``render/meshcast.patch_cull_plain``, the group cone's pre-test of the
block boxes and each patch's cone over the triangles' spheres
(``triangle_spheres``), and ``render/meshcast.segment_cull_plain``, each
set of 32 keypoint segments' own tests of the box, word and triangle
spheres merged over the set.

The scenes are tests/test_torch_meshsweep.py's: the default roster and two
dumpers with three workers, two frames (frame 0 looks at the first worker
from 2 m, frame 1 over the site), pixel rays at 64^2 and 96 x 64 in 32 x 32
tiles. No JAX runs here: the plain sweep's agreement with the JAX package
is tests/test_torch_meshsweep.py's. What a cull may drop is held exactly:
the pre-test keeps every box the slab test visits, each patch keeps every
triangle that one of its rays passes by the kernel's division-free test
widened by 8 ulps, and the plain sweep over the kept pairs alone is the
full plain sweep bit for bit, misses' codes included; the same holds for
each set of segments. The kernel's own kept words are held to the mirrors
on the card (tests/test_torch_cuda.py).
"""

import math

import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.render import meshcast, raycast
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
SCENES = {"default": SceneConfig(), "two_dumpers": SceneConfig(n_dumpers=2, n_humans=3)}
SIZES = {"64x64": (64, 64), "96x64": (96, 64)}  # width, height
WIDEN = 8.0  # ulps of each dot's terms, as chip_smoke.py's MESH_WIDEN_ULPS


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    """The roster, world, cameras and pixel rays of each size, with each
    size's caster, terms and visited triples."""
    sc = SCENES[request.param]
    pipe = Pipeline(Config(scene=sc, pipeline=PipelineConfig(render_width=64,
                                                            render_height=64)), device="cpu")
    inputs = pipe.sample_inputs(4, [0, 10])
    w = world.build_world(pipe.roster, inputs.pose)
    human = w["inst_pos"][0, pipe.roster.human_slice[0]]
    cam = torch.stack([human + torch.tensor([1.6, 1.2, 0.5]), torch.tensor([13.0, -9.0, 3.5])])
    tgt = torch.stack([human + torch.tensor([0.0, 0.0, 0.9]), torch.tensor([0.0, 0.0, 1.0])])
    M = camera.look_at_matrix(cam, tgt)
    sizes = {}
    for key, (W, H) in SIZES.items():
        px = camera.pixel_rays(camera.intrinsics_from_apertures(12.0, 25.0, W, H),
                               M).reshape(2, -1, 3)
        mesh = meshcast.make_mesh_caster(pipe.roster, grid_hw=(H, W))
        m = mesh.mesh_terms(w, cam)
        lay = mesh.layout(px.shape[1])
        visited = meshcast.block_hits(cam, meshcast.group_rays(px, lay), m.lo, m.hi)
        sizes[key] = (mesh, m, px, lay, visited)
    kp = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"]).reshape(2, -1, 3)
    return pipe.roster, w, cam, sizes, (kp - cam[:, None]).contiguous()


@pytest.mark.parametrize("size", list(SIZES))
def test_box_pretest_keeps_every_visited_box(scene, size):
    """The tile's cone keeps every box the slab test visits; the keypoint
    segments (one group a frame, not tiles) take every box to the slab
    test."""
    roster, w, cam, sizes, seg = scene
    mesh, m, px, lay, visited = sizes[size]
    boxes, kept = meshcast.patch_cull_plain(m.lo, m.hi, m.spheres, cam, px, lay, "split")
    assert kept is None and boxes.shape == visited.shape
    assert bool(visited.any()) and not bool((visited & ~boxes).any())
    # It culls: a 32 x 32 tile's cone leaves out most boxes.
    assert int(boxes.sum()) < 0.5 * boxes.numel()
    seg_lay = mesh.layout(seg.shape[1])
    seg_visited = meshcast.block_hits(cam, meshcast.group_rays(seg, seg_lay), m.lo, m.hi)
    seg_boxes, _ = meshcast.patch_cull_plain(m.lo, m.hi, m.spheres, cam, seg, seg_lay, "split")
    assert bool(seg_boxes.all()) and bool(seg_visited.any())


def _triples(visited, step=16):
    t = torch.nonzero(visited)
    return [t[c:c + step].unbind(1) for c in range(0, t.shape[0], step)]


@pytest.fixture(scope="module")
def walks(scene):
    """At 64^2, for the patch walk: the mirror's kept triangles, the pairs
    of the visited blocks that pass the kernel's test widened by WIDEN
    ulps with their triangle not kept by the ray's patch (``lost``), the
    (patch, triangle) pairs some ray passes (``needed``) and those kept;
    and the plain sweep restricted to the kept pairs (``sweep``), whose
    reciprocal, t and checks are plain_mesh_sweep's, beside the full
    plain_mesh_sweep (``full``) and the count of pairs its test passes."""
    _, _, cam, sizes, _ = scene
    mesh, m, px, lay, visited = sizes["64x64"]
    codes = mesh._on("cpu")["codes"]
    T = m.terms.shape[-1]
    W, tn = meshcast.block_matrices(m.terms)
    rays = meshcast.group_rays(px, lay)
    B, G, R = rays.shape[:3]
    n, (ph, pw) = meshcast.PATCH_SIDE, meshcast.PATCH_SHAPE
    rows, cols = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    kept = meshcast.patch_cull_plain(m.lo, m.hi, m.spheres, cam, px, lay)[1]
    # The patch of each ray of a tile, in group_rays order.
    patch = ((rows // ph) * (n // pw) + cols // pw).reshape(-1)
    out = {"full": meshcast.plain_mesh_sweep(m.terms, m.lo, m.hi, codes, cam, px, lay),
           "passing": 0, "kept": kept, "lost": 0, "needed": 0, "kept_pairs": 0}
    best = torch.full((B * G, R), raycast.INF)
    for c, (b, g, k) in enumerate(_triples(visited)):
        widened = meshcast.pair_passes(W[b, k], rays[b, g], WIDEN)
        if c == 0:
            assert not bool((meshcast.pair_passes(W[b, k], rays[b, g]) & ~widened).any())
        D = torch.bmm(rays[b, g], W[b, k])
        det = D[..., :T]
        inv = torch.where(torch.abs(det) < raycast.EPS, 0.0, torch.reciprocal(det))
        u, v = D[..., T:].unflatten(-1, (2, T)).mul_(inv[:, :, None]).unbind(2)
        t = tn[b, k][:, None, :] * inv
        ok = (torch.minimum(u, v) >= 0.0) & (u + v <= 1.0) & (t > raycast.EPS)
        out["passing"] += int(ok.sum())
        mine = kept[b, g, :, k]  # (V, patches, T)
        per_ray = mine[:, patch]  # (V, R, T)
        out["lost"] += int((widened & ~per_ray).sum())
        V = widened.shape[0]
        need = (widened.reshape(V, n // ph, ph, n // pw, pw, T).transpose(2, 3)
                .reshape(V, -1, ph * pw, T).any(2))
        if c == 0:
            assert torch.equal(need, meshcast.patch_passes(W[b, k], rays[b, g], WIDEN))
        out["needed"] += int(need.sum())
        out["kept_pairs"] += int(mine.sum()) * ph * pw
        t_min = torch.where(ok & per_ray, t, float(raycast.INF)).amin(dim=2)
        pk = raycast._pack(t_min, codes[k, None])
        best.scatter_reduce_(0, (b * G + g)[:, None].expand(-1, R), pk, "amin")
    out["sweep"] = meshcast.ungroup(best.reshape(B, G, R), lay)
    out["visited_pairs"] = int(visited.sum()) * R * T
    return out


def test_patch_cull_keeps_every_passing_pair(walks):
    """Every (ray, triangle) pair of a visited block that passes the
    kernel's division-free test widened by 8 ulps (``pair_passes``, as
    chip_smoke.py's ``mesh_pair_passes`` computes it, widened) has its
    triangle kept by the ray's patch; the cull drops most pairs."""
    ph, pw = meshcast.PATCH_SHAPE
    assert walks["kept"].shape[2] == 1024 // (ph * pw) and walks["kept"].shape[4] == 512
    assert walks["passing"] > 1000 and walks["needed"] > 0
    assert walks["lost"] == 0
    assert walks["kept_pairs"] < 0.2 * walks["visited_pairs"]


def test_sweep_over_kept_pairs_is_the_full_sweep(walks):
    """The plain sweep restricted to the kept pairs equals plain_mesh_sweep
    bit for bit, the misses' pack(INF, least visited code) included: a
    culled pair is one that misses."""
    full = walks["full"]
    assert torch.equal(walks["sweep"].view(torch.int32), full.view(torch.int32))
    t, _ = raycast._unpack(full)
    hit = t < raycast.INF * 0.99
    assert 0 < int(hit.sum()) < hit.numel()


@pytest.fixture(scope="module")
def segment_walks(scene):
    """For the keypoint segments (one group a frame, both frames), the
    segment walk's mirror: its kept triangles a set (``kept``), the pairs
    of the visited blocks that pass the kernel's test widened by WIDEN ulps
    with their triangle not kept by the ray's set (``lost``), the pairs
    kept a ray; and the plain sweep restricted to the kept pairs
    (``sweep``) beside the full plain_mesh_sweep (``full``)."""
    _, _, cam, sizes, seg = scene
    mesh, m, _, _, _ = sizes["64x64"]
    codes, lay = mesh._on("cpu")["codes"], mesh.layout(seg.shape[1])
    T = m.terms.shape[-1]
    W, tn = meshcast.block_matrices(m.terms)
    rays = meshcast.group_rays(seg, lay)
    B, G, R = rays.shape[:3]
    visited = meshcast.block_hits(cam, rays, m.lo, m.hi)
    kept = meshcast.segment_cull_plain(m.lo, m.hi, m.spheres, cam, seg, lay)
    set_of = torch.arange(R) // meshcast.SET
    out = {"full": meshcast.plain_mesh_sweep(m.terms, m.lo, m.hi, codes, cam, seg, lay),
           "kept": kept, "lay": lay, "passing": 0, "lost": 0, "kept_pairs": 0}
    best = torch.full((B * G, R), raycast.INF)
    for c, (b, g, k) in enumerate(_triples(visited)):
        widened = meshcast.pair_passes(W[b, k], rays[b, g], WIDEN, tn[b, k])
        if c == 0:
            exact = meshcast.pair_passes(W[b, k], rays[b, g], tn=tn[b, k])
            assert not bool((exact & ~widened).any())
            assert not bool((exact & ~meshcast.pair_passes(W[b, k], rays[b, g])).any())
        per_ray = kept[b, g, :, k][:, set_of]  # (V, R, T)
        D = torch.bmm(rays[b, g], W[b, k])
        det = D[..., :T]
        inv = torch.where(torch.abs(det) < raycast.EPS, 0.0, torch.reciprocal(det))
        u, v = D[..., T:].unflatten(-1, (2, T)).mul_(inv[:, :, None]).unbind(2)
        t = tn[b, k][:, None, :] * inv
        ok = (torch.minimum(u, v) >= 0.0) & (u + v <= 1.0) & (t > raycast.EPS)
        out["passing"] += int(widened.sum())
        out["lost"] += int((widened & ~per_ray).sum())
        out["kept_pairs"] += int(per_ray.sum())
        t_min = torch.where(ok & per_ray, t, float(raycast.INF)).amin(dim=2)
        pk = raycast._pack(t_min, codes[k, None])
        best.scatter_reduce_(0, (b * G + g)[:, None].expand(-1, R), pk, "amin")
    out["sweep"] = meshcast.ungroup(best.reshape(B, G, R), lay)
    out["visited_pairs"] = int(visited.sum()) * R * T
    return out


def test_segment_cull_keeps_every_passing_pair(segment_walks):
    """Every (segment, triangle) pair of a visited block that passes the
    kernel's test widened by 8 ulps, t > EPS included (a frame's segments
    fan out, so its visited blocks lie behind some of them), has its
    triangle kept by the segment's set of 32; the cull drops nearly every
    visited pair."""
    sw = segment_walks
    B, G, S, nb, T = sw["kept"].shape
    assert (G, S, T) == (1, -(-sw["lay"].rays // meshcast.SET), meshcast.KERNEL_TRI_BLOCK)
    assert sw["passing"] > 100 and sw["lost"] == 0
    assert sw["kept_pairs"] < 0.05 * sw["visited_pairs"]


def test_segment_sweep_over_kept_pairs_is_the_full_sweep(segment_walks):
    """The plain sweep of the segments restricted to each set's kept pairs
    equals plain_mesh_sweep bit for bit, the misses' pack(INF, least
    visited code) included."""
    full = segment_walks["full"]
    assert torch.equal(segment_walks["sweep"].view(torch.int32), full.view(torch.int32))
    t, _ = raycast._unpack(full)
    hit = t < raycast.INF * 0.99
    assert 0 < int(hit.sum()) < hit.numel()


def test_word_spheres_hold_their_triangles(scene):
    """Each word's sphere holds the spheres of its real triangles; a word
    of padding only has radius -1."""
    _, _, _, sizes, _ = scene
    _, m, _, _, _ = sizes["64x64"]
    words = meshcast.word_spheres(m.spheres)
    B, nb = m.spheres.shape[:2]
    assert words.shape == (B, nb, 4, meshcast.WORDS)
    sph = m.spheres.unflatten(-1, (meshcast.WORDS, 32))  # (B, nb, 4, WORDS, 32)
    real = sph[:, :, 3] >= 0
    gap = torch.linalg.norm(sph[:, :, :3] - words[:, :, :3, :, None], dim=2) + sph[:, :, 3]
    assert bool((gap <= words[:, :, 3, :, None])[real].all())
    empty = ~real.any(-1)
    assert bool(empty.any()) and bool((words[:, :, 3][empty] == -1).all())
    assert bool((words[:, :, 3][~empty] > 0).all())


def test_one_ray_keeps_small_far_spheres_on_its_line():
    """``_ray_meets`` keeps a 5 mm sphere centred on the ray from 1 m to 300
    m (the cross product holds the distance where a cos^2 test would round
    it away), drops it 1 mm beside its reach or behind the origin, and
    keeps any sphere that holds the origin, for a zero direction too."""
    gen = torch.Generator().manual_seed(5)
    u = torch.randn(64, 3, generator=gen)
    u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    side = torch.linalg.cross(u, torch.randn(64, 3, generator=gen), dim=-1)
    side = side / torch.linalg.norm(side, dim=-1, keepdim=True)
    r = 5e-3
    for dist in (1.0, 30.0, 100.0, 300.0):
        ball = lambda c: torch.cat([c, torch.full((64, 1), r)], -1)
        assert bool(meshcast._ray_meets(u, ball(dist * u)).all())
        reach = r + raycast.CULL_ABS * dist + 1e-3
        assert not bool(meshcast._ray_meets(u, ball(dist * u + reach * side)).any())
        assert not bool(meshcast._ray_meets(u, ball(-dist * u)).any())
    around = torch.cat([0.3 * side, torch.full((64, 1), 0.5)], -1)
    assert bool(meshcast._ray_meets(u, around).all())
    assert bool(meshcast._ray_meets(torch.zeros(64, 3), around).all())
    assert not bool(meshcast._ray_meets(u, torch.cat([0.3 * side, -torch.ones(64, 1)], -1)).any())


def test_a_set_with_a_wild_direction_keeps_every_real_triangle(scene):
    """A set of segments with a non-finite direction keeps every triangle
    with a sphere, in every block; the other sets cull as before."""
    _, _, cam, sizes, seg = scene
    _, m, _, _, _ = sizes["64x64"]
    lay = meshcast.ray_layout(seg.shape[1], 1024, None)
    wild = seg.clone()
    wild[:, 33, 1] = float("nan")
    kept = meshcast.segment_cull_plain(m.lo, m.hi, m.spheres, cam, wild, lay)
    real = (m.spheres[:, :, 3] >= 0)[:, None]  # (B, 1, nb, T)
    assert torch.equal(kept[:, :, 1], real.expand_as(kept[:, :, 1]))
    calm = meshcast.segment_cull_plain(m.lo, m.hi, m.spheres, cam, seg, lay)
    assert torch.equal(torch.cat([kept[:, :, :1], kept[:, :, 2:]], 2),
                       torch.cat([calm[:, :, :1], calm[:, :, 2:]], 2))
    assert int(calm[:, :, 1].sum()) < 0.2 * int(real.sum())


def test_spheres_hold_their_corners_and_mark_the_padding(scene):
    """Each triangle's sphere holds its three corners; the padding
    triangles (and only triangles with cr = 0) have radius -1."""
    _, w, cam, sizes, _ = scene
    mesh, m, _, _, _ = sizes["64x64"]
    B, nb, T = 2, mesh.n_blocks, mesh.tri_block
    assert m.spheres.shape == (B, nb, 4, T) and m.spheres.is_contiguous()
    sph = m.spheres.transpose(2, 3)
    centre, r = sph[..., :3] + cam[:, None, None], sph[..., 3]
    real = r >= 0
    for c in mesh.corners(w):
        assert bool((torch.linalg.norm(c - centre, dim=-1)[real] <= r[real]).all())
    cr = m.terms[:, :, :3].transpose(2, 3)
    assert torch.equal(~real, (cr == 0).all(-1))
    pad = torch.zeros(nb, T, dtype=torch.bool)
    start = 0
    for c in mesh.classes:
        for _ in c.ids:
            blocks = torch.zeros(c.n_blocks * T, dtype=torch.bool)
            blocks[c.n_faces:] = True
            pad[start:start + c.n_blocks] = blocks.reshape(c.n_blocks, T)
            start += c.n_blocks
    assert bool(pad.any()) and bool((~real[:, pad]).all())


def test_a_cone_past_a_right_angle_keeps_every_triangle_but_the_padding(scene):
    """Patches whose rays span more than pi / 2 (each tile's rays turned to
    all directions) keep every triangle with a sphere, in every block, and
    no padding triangle; the group cone keeps every box."""
    _, _, cam, sizes, _ = scene
    _, m, px, lay, _ = sizes["64x64"]
    gen = torch.Generator().manual_seed(1)
    wide = torch.randn(px.shape, generator=gen)
    boxes, kept = meshcast.patch_cull_plain(m.lo, m.hi, m.spheres, cam, wide, lay)
    assert bool(boxes.all())
    real = (m.spheres[:, :, 3] >= 0)[:, None, None]  # (B, 1, 1, nb, T)
    assert torch.equal(kept, real.expand_as(kept))


def test_a_camera_inside_a_sphere_keeps_it(scene):
    """A patch looking away from a triangle keeps it while the camera lies
    inside its sphere, and culls it once the sphere is moved off the
    camera."""
    _, _, cam, sizes, _ = scene
    _, m, px, lay, _ = sizes["64x64"]
    sph = m.spheres.clone()
    # Triangle 0 of block 0: centred 1 mm behind each camera, radius 1 cm.
    look = px[:, :1].reshape(2, 3)
    sph[:, 0, :3, 0] = -1e-3 * look / torch.linalg.norm(look, dim=-1, keepdim=True)
    sph[:, 0, 3, 0] = 1e-2
    _, kept = meshcast.patch_cull_plain(m.lo, m.hi, sph, cam, px, lay)
    assert bool(kept[:, :, :, 0, 0].all())
    sph[:, 0, :3, 0] *= 1e3  # 1 m behind
    _, kept = meshcast.patch_cull_plain(m.lo, m.hi, sph, cam, px, lay)
    assert not bool(kept[:, :, :, 0, 0].any())


def test_box_spheres_hold_their_boxes(scene):
    """The box pre-test's spheres hold each box's eight corners."""
    _, _, cam, sizes, _ = scene
    _, m, _, _, _ = sizes["96x64"]
    bs = meshcast.box_spheres(m.lo, m.hi, cam)
    for corner in range(8):
        pick = [(corner >> a) & 1 for a in range(3)]
        c = torch.stack([(m.hi if p else m.lo)[..., a] for a, p in enumerate(pick)], -1)
        assert bool((torch.linalg.norm(c - cam[:, None] - bs[..., :3], dim=-1)
                     <= bs[..., 3]).all())


def test_kept_words_unpack_bit_by_bit():
    """``kept_triangles``: bit i % 32 of word i // 32 is triangle i, the sign
    bit included; ``kept_shape`` is the kernel's layout."""
    rng = np.random.default_rng(0)
    bits = torch.as_tensor(rng.random((3, 5, meshcast.WORDS * 32)) < 0.3)
    words = torch.zeros(3, 5, meshcast.WORDS, dtype=torch.int64)
    for i in range(meshcast.WORDS * 32):
        words[..., i // 32] |= bits[..., i].long() << (i % 32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()
    assert torch.equal(meshcast.kept_triangles(words), bits)
    lay = meshcast.ray_layout(512 * 512, 1024, (512, 512))
    assert meshcast.kept_shape(2, lay, 89) == (2, 256, 32, 89, meshcast.WORDS)


def test_walk_choice():
    """The patch walk on 32 x 32 pixel tiles that fill the card, the
    segment walk on every layout that is not a pixel grid (the keypoint
    segments, in one group or in ranges, however few frames), the split
    walk elsewhere (small frames, other tiles)."""
    tiles = meshcast.ray_layout(512 * 512, 1024, (512, 512))
    assert meshcast.mesh_walk(2, tiles) == meshcast.PATCH
    assert meshcast.mesh_walk(1, meshcast.ray_layout(128 * 128, 1024, (128, 128))) == "split"
    for n, B in ((680, 64), (680, 1), (3072, 2), (1500, 4)):
        assert meshcast.mesh_walk(B, meshcast.ray_layout(n, 1024, None)) == meshcast.SEGMENTS
    assert meshcast.mesh_walk(64, meshcast.ray_layout(512 * 512, 256, (512, 512))) == "split"
    assert math.isqrt(1024) == meshcast.PATCH_SIDE
    assert meshcast.kept_shape(2, meshcast.ray_layout(680, 1024, None), 89) == (
        2, 1, 22, 89, meshcast.WORDS)


@pytest.mark.parametrize("walk", list(meshcast.WALKS))
def test_wrapper_passes_the_entry_points_arguments(scene, monkeypatch, walk):
    """``mesh_sweep_cuda`` hands ``cspe_mesh_sweep`` one argument for each
    of its C parameters but the stream, pointers (tensors or None) where it
    takes a pointer and ints where it takes an int, the walk's number
    among them."""
    from constructionsceneposeestimation_tpu_torch.utils import kernels
    _, _, cam, sizes, seg = scene
    mesh, m, px, lay, _ = sizes["64x64"]
    if walk == meshcast.SEGMENTS:  # the keypoint segments, one group a frame
        px, lay = seg, mesh.layout(seg.shape[1])
    seen = []
    monkeypatch.setattr(kernels, "check_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "launch", lambda name, *args: seen.append((name, args)))
    kept = (None if walk == "split" else
            torch.zeros(meshcast.kept_shape(2, lay, mesh.n_blocks), dtype=torch.int32))
    meshcast.mesh_sweep_cuda(m.terms, m.lo, m.hi, m.spheres, mesh._on("cpu")["codes"], cam, px,
                             lay, torch.zeros(2, lay.groups, dtype=torch.int32), kept, walk)
    (name, args), = seen
    sig = kernels.SIGNATURES[name][:-1]  # the stream is the last
    assert len(args) == len(sig)
    for a, t in zip(args, sig):
        assert isinstance(a, int) if t is kernels._I else (a is None or torch.is_tensor(a))
    ints = [a for a in args if isinstance(a, int)]
    assert ints == [2, mesh.n_blocks, px.shape[1], lay.groups, lay.rays, lay.grid_w, lay.side,
                    meshcast.WALKS[walk]]
    if walk == meshcast.SEGMENTS:  # the walk the segments take by default
        assert meshcast.mesh_walk(2, lay) == walk


def test_a_hifi_render_builds_the_mesh_terms_once(monkeypatch):
    """``render_frame`` on the hifi tier builds ``mesh_terms`` once for its
    pixel sweep and keypoint segments (``HifiCaster.frame_world``), and
    gives the frames it gave with a build for each sweep."""
    pipe = Pipeline(Config(pipeline=PipelineConfig(render_width=32, render_height=32,
                                                   batch_size=1)), device="cpu", hifi_mesh=True)
    gen = pipe.make_generate_fn()
    calls = []
    mesh_terms = meshcast.MeshCaster.mesh_terms

    def counting(self, world, ray_o):
        calls.append(ray_o)
        return mesh_terms(self, world, ray_o)

    monkeypatch.setattr(meshcast.MeshCaster, "mesh_terms", counting)
    once = gen(3, range(1))
    assert len(calls) == 1
    monkeypatch.setattr(meshcast.HifiCaster, "frame_world", lambda self, world, cam: world)
    twice = gen(3, range(1))
    assert len(calls) == 3
    for f in once._fields:
        assert torch.equal(getattr(once, f), getattr(twice, f)), f


@pytest.fixture(scope="module")
def hifi(scene):
    """The scene's hifi caster at 64^2, a world from its ``frame_world`` for
    the cameras, and rays from them in one group a frame: every 32nd pixel
    ray and every 8th keypoint segment."""
    roster, w, cam, sizes, seg = scene
    caster = meshcast.HifiCaster(roster, grid_hw=(64, 64))
    d = torch.cat([sizes["64x64"][2][:, ::32], seg[:, ::8]], 1).contiguous()
    return caster, caster.frame_world(w, cam), d


@pytest.mark.parametrize("origin", ["the camera", "a copy of the camera", "another point"])
def test_a_frame_world_sweeps_right_from_any_origin(scene, hifi, monkeypatch, origin):
    """``MeshCaster.packed`` on a world from ``HifiCaster.frame_world`` uses
    its mesh terms only for the very camera tensor they were built for,
    and builds them anew for any other origin, so that its sweep equals
    the sweep of terms built for that origin, bit for bit. The camera's
    terms, swept from another point, would differ."""
    _, w, cam, _, _ = scene
    caster, fw, d = hifi
    mesh, m = caster.mesh, fw["mesh_terms"]
    codes, lay = mesh._on("cpu")["codes"], mesh.layout(d.shape[1])
    o = {"the camera": cam, "a copy of the camera": cam.clone(),
         "another point": cam + torch.tensor([0.7, -0.4, 0.3])}[origin]
    builds = []
    mesh_terms = meshcast.MeshCaster.mesh_terms

    def counting(self, world, ray_o):
        builds.append(ray_o)
        return mesh_terms(self, world, ray_o)

    monkeypatch.setattr(meshcast.MeshCaster, "mesh_terms", counting)
    got = mesh.packed(fw, o, d)
    assert len(builds) == (0 if o is cam else 1) and all(b is o for b in builds)
    stale = meshcast.plain_mesh_sweep(m.terms, m.lo, m.hi, codes, o, d, lay)
    if origin == "another point":
        want = mesh.packed(w, o, d)
        assert not torch.equal(stale.view(torch.int32), want.view(torch.int32))
    else:
        want = stale  # the camera's terms, for the camera's values
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    t, _ = raycast._unpack(want)
    assert 0 < int((t < raycast.INF * 0.99).sum()) < t.numel()
