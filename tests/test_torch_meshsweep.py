"""The mesh sweep's kernel split (``render/meshcast.py``: ``mesh_terms``,
``plain_mesh_sweep``, ``mesh_sweep_cuda``) against the JAX package, on the
CPU.

``mesh_terms`` + ``plain_mesh_sweep`` run on the port's world and rays and
the JAX ``make_mesh_caster`` on the same world (as numpy) and rays, on the
default scene and on the scene of two dumpers and three workers, at 64^2
and 96 x 64, in each of the three ray groupings: square pixel tiles,
contiguous ranges, and one group of more than ``tile`` rays. Tolerances
are tests/test_torch_meshcast.py's (and tests/test_meshcast.py's): hit
agreement > 0.999, |dt| < 1e-3 m on common hits (the packed payload takes
6 mantissa bits), instance exact on common hits. The term layout rebuilds
the per-block matrices of the dots bit for bit, the group order is the
one csrc/meshsweep.cu computes, and on CPU tensors nothing reaches the
kernel: ``packed`` takes the plain version, and the wrapper refuses wrong
types, shapes, layouts and ``tri_block`` before any launch. The kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.render import meshcast as jmesh
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.render import meshcast, raycast
from constructionsceneposeestimation_tpu_torch.scene import world
from constructionsceneposeestimation_tpu_torch.utils import kernels

torch.set_num_threads(2)
SCENES = {"default": SceneConfig(), "two_dumpers": SceneConfig(n_dumpers=2, n_humans=3)}
SIZES = {"64x64": (64, 64), "96x64": (96, 64)}  # width, height


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    """Two frames of the port's sampled scenes at 64^2 (frame 0 looks at the
    first worker from 2 m, frame 1 over the site), their 64^2 and 96 x 64
    pixel rays, and 1100 rays a frame (the keypoint segments, then rays at
    the scene): one group of more than a tile."""
    sc = SCENES[request.param]
    pipe = Pipeline(Config(scene=sc, pipeline=PipelineConfig(render_width=64,
                                                            render_height=64)), device="cpu")
    inputs = pipe.sample_inputs(4, [0, 10])
    w = world.build_world(pipe.roster, inputs.pose)
    human = w["inst_pos"][0, pipe.roster.human_slice[0]]
    cam = torch.stack([human + torch.tensor([1.6, 1.2, 0.5]), torch.tensor([13.0, -9.0, 3.5])])
    tgt = torch.stack([human + torch.tensor([0.0, 0.0, 0.9]), torch.tensor([0.0, 0.0, 1.0])])
    M = camera.look_at_matrix(cam, tgt)
    px = {k: camera.pixel_rays(camera.intrinsics_from_apertures(12.0, 25.0, *wh), M)
          .reshape(2, -1, 3) for k, wh in SIZES.items()}
    kp = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"]).reshape(2, -1, 3)
    seg = kp - cam[:, None]
    gen = torch.Generator().manual_seed(0)
    aim = (torch.rand(2, 1100 - seg.shape[1], 3, generator=gen) - 0.5) * torch.tensor(
        [24.0, 24.0, 6.0])
    one = torch.cat([seg, aim + torch.tensor([0.0, 0.0, 2.0]) - cam[:, None]], dim=1)
    return sc, pipe.roster, w, cam, px, one


def _jax_packed(sc, w, cam, rays, **kw):
    mesh = jmesh.make_mesh_caster(jworld.make_roster(sc), **kw)
    jw = {k: jnp.asarray(w[k].numpy()) for k in ("inst_rot", "inst_pos", "prim_rot", "prim_pos")}
    return np.asarray(jax.jit(jax.vmap(mesh))(jw, jnp.asarray(cam.numpy()),
                                              jnp.asarray(rays.numpy())))


def _agree(mine, ref, min_hits):
    tm, cm = (x.numpy() for x in raycast._unpack(mine))
    tr, cr = (x.numpy() for x in raycast._unpack(torch.as_tensor(np.array(ref))))
    hm, hr = tm < raycast.INF * 0.99, tr < raycast.INF * 0.99
    both = hm & hr
    assert (hm == hr).mean() > 0.999
    assert both.sum() >= min_hits
    assert np.abs(tm[both] - tr[both]).max() < 1e-3
    np.testing.assert_array_equal(cm[both], cr[both])


def _plain(mesh, w, cam, rays):
    m = mesh.mesh_terms(w, cam)
    return meshcast.plain_mesh_sweep(m.terms, m.lo, m.hi, mesh._on("cpu")["codes"], cam, rays,
                                     mesh.layout(rays.shape[1]))


@pytest.mark.parametrize("size", list(SIZES))
def test_pixel_tiles_match_jax(scene, size):
    """Square 32 x 32 tiles on the pixel grid (2 x 2 and 2 x 3 of them)."""
    sc, roster, w, cam, px, _ = scene
    W, H = SIZES[size]
    mesh = meshcast.make_mesh_caster(roster, grid_hw=(H, W))
    lay = mesh.layout(H * W)
    assert (lay.groups, lay.rays, lay.grid_w, lay.side) == (H * W // 1024, 1024, W, 32)
    _agree(_plain(mesh, w, cam, px[size]), _jax_packed(sc, w, cam, px[size], grid_hw=(H, W)),
           500)


def test_contiguous_ranges_match_jax(scene):
    """Contiguous ranges of 256 rays (the 64^2 pixels, no grid)."""
    sc, roster, w, cam, px, _ = scene
    mesh = meshcast.make_mesh_caster(roster, tile=256)
    assert mesh.layout(4096) == meshcast.RayLayout(16, 256, 0, 16)
    _agree(_plain(mesh, w, cam, px["64x64"]), _jax_packed(sc, w, cam, px["64x64"], tile=256),
           500)


def test_one_group_of_more_than_a_tile_matches_jax(scene):
    """1100 rays a frame, which 1024 does not divide: one group of all."""
    sc, roster, w, cam, _, one = scene
    mesh = meshcast.make_mesh_caster(roster)
    assert mesh.layout(1100) == meshcast.RayLayout(1, 1100, 0, 32)
    _agree(_plain(mesh, w, cam, one), _jax_packed(sc, w, cam, one), 300)


def test_terms_rebuild_the_block_matrices(scene):
    """``mesh_terms``' rows give back, bit for bit, the (3, 3T) matrix and
    t_num of the per-triangle vectors computed from the corners."""
    _, roster, w, cam, _, _ = scene
    mesh = meshcast.make_mesh_caster(roster)
    m = mesh.mesh_terms(w, cam)
    terms, lo, hi = m.terms, m.lo, m.hi
    B, nb, T = 2, mesh.n_blocks, mesh.tri_block
    assert terms.shape == (B, nb, meshcast.N_TERMS, T) and terms.is_contiguous()
    c0, c1, c2 = mesh.corners(w)
    e1, e2 = c1 - c0, c2 - c0
    s = cam[:, None, None, :] - c0
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    qv = cross(s, e1)
    want_W = torch.cat([cross(e2, e1), cross(e2, s), qv], dim=2).transpose(2, 3)
    W, tn = meshcast.block_matrices(terms)
    assert torch.equal(W, want_W) and torch.equal(tn, torch.sum(e2 * qv, dim=-1))
    corner_lo = torch.minimum(torch.minimum(c0, c1), c2).amin(dim=2)
    corner_hi = torch.maximum(torch.maximum(c0, c1), c2).amax(dim=2)
    assert bool((lo < corner_lo).all() and (hi > corner_hi).all())


@pytest.mark.parametrize("layout", [(4096, 1024, (64, 64)), (6144, 1024, (64, 96)),
                                    (4096, 256, None), (1100, 1024, None)])
def test_group_order_is_the_kernels(layout):
    """``group_rays`` puts ray r of group g where csrc/meshsweep.cu's
    ``ray_index`` reads it, and ``ungroup`` undoes it."""
    n, tile, grid_hw = layout
    lay = meshcast.ray_layout(n, tile, grid_hw)
    g, r = np.meshgrid(np.arange(lay.groups), np.arange(lay.rays), indexing="ij")
    if lay.grid_w:
        tiles_x = lay.grid_w // lay.side
        want = ((g // tiles_x * lay.side + r // lay.side) * lay.grid_w
                + g % tiles_x * lay.side + r % lay.side)
    else:
        want = g * lay.rays + r
    ids = torch.arange(n)[None].repeat(2, 1)
    grouped = meshcast.group_rays(ids, lay)
    assert grouped.shape == (2, lay.groups, lay.rays)
    np.testing.assert_array_equal(grouped[1].numpy(), want)
    assert torch.equal(meshcast.ungroup(grouped, lay), ids)


def test_packed_on_cpu_takes_the_plain_version(scene, monkeypatch):
    _, roster, w, cam, px, one = scene
    mesh = meshcast.make_mesh_caster(roster, grid_hw=(64, 64))

    def no_launch(*a):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(kernels, "launch", no_launch)
    before = meshcast.mesh_sweep_cuda.launches
    for rays in (px["64x64"], one):
        assert torch.equal(mesh.packed(w, cam, rays).view(torch.int32),
                           _plain(mesh, w, cam, rays).view(torch.int32))
    assert meshcast.mesh_sweep_cuda.launches == before


def test_wrapper_refuses_before_any_launch(scene, monkeypatch):
    """Wrong dtype, shape, layout, walk or tri_block, and CPU tensors, raise
    before a launch."""
    _, roster, w, cam, px, one = scene
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("launched"))
    mesh = meshcast.make_mesh_caster(roster, grid_hw=(64, 64))
    m = mesh.mesh_terms(w, cam)
    terms, lo, hi, spheres = m.terms, m.lo, m.hi, m.spheres
    codes, rays, lay = mesh._on("cpu")["codes"], px["64x64"], mesh.layout(4096)
    args = dict(terms=terms, lo=lo, hi=hi, spheres=spheres, codes=codes, ray_o=cam, ray_d=rays,
                lay=lay)
    small = meshcast.make_mesh_caster(roster, tri_block=256, grid_hw=(64, 64))
    kept = torch.zeros(meshcast.kept_shape(2, lay, mesh.n_blocks), dtype=torch.int32)
    cases = {
        "tri_block": (dict(terms=small.mesh_terms(w, cam).terms), "tri_block"),
        "dtype": (dict(codes=codes.long()), "mesh codes"),
        "shape": (dict(lo=lo[:, 1:]), "mesh lo"),
        "spheres": (dict(spheres=spheres[..., 1:]), "mesh spheres"),
        "layout": (dict(lay=mesh.layout(2048)), "layout"),
        "visits": (dict(visits=torch.zeros(2, 3, dtype=torch.int32)), "mesh visits"),
        "walk": (dict(walk="4x4"), "walk"),
        "patch walk off tiles": (dict(ray_d=one, lay=mesh.layout(1100), walk="4x8"), "tiles"),
        "kept without a patch walk": (dict(kept=kept, walk="split"), "patch walk"),
        "kept": (dict(kept=kept[:, 1:], walk="4x8"), "mesh kept"),
        "device": ({}, "expected a CUDA tensor"),
    }
    before = meshcast.mesh_sweep_cuda.launches
    for name, (change, match) in cases.items():
        with pytest.raises(ValueError, match=match):
            meshcast.mesh_sweep_cuda(**{**args, **change})
    assert meshcast.mesh_sweep_cuda.launches == before
