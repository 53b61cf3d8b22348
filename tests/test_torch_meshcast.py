"""The hifi CAD-mesh tier of the port (``render/meshcast.py``, the masked
caster and schedule, ``Pipeline(hifi_mesh=True)``) against the JAX
package.

The mesh sweep runs on both sides on the same world (the port's, handed to
JAX as numpy) and the same rays: the 64^2 pixel grid of two cameras (square
tiles; one aimed at the skinned worker) and 2048 rays a frame on the
contiguous-range path (the keypoint segments plus rays at the scene).
Tolerances are tests/test_meshcast.py's: hit agreement > 0.999, |dt| < 1e-3
m on common hits (the packed payload takes 6 mantissa bits), instance
exact on common hits. The data files are byte copies and the Morton order
is exact. The hifi render's box labels come from the templates, so they
are bit-equal to the proxy render's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.render import meshcast as jmesh
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.render import meshcast, raycast, sweep_kernel
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
RES = 64
CFG = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES))


def test_data_files_are_copies():
    for name in ("mesh_templates.npz", "worker_skin.npz"):
        mine = (meshcast.DATA_DIR / name).read_bytes()
        with open(jmesh.DATA_NPZ.replace("mesh_templates.npz", name), "rb") as f:
            assert mine == f.read(), name


def test_morton_sort_matches_jax():
    tpl = meshcast.load_templates()
    skin = meshcast.load_skin()
    cases = [*tpl.values(), (skin["verts"], skin["faces"])]
    assert list(tpl) == list(jmesh.load_templates())
    for v, f in cases:
        np.testing.assert_array_equal(meshcast._morton_sort_faces(v, f),
                                      jmesh._morton_sort_faces(v, f))


@pytest.fixture(scope="module")
def scene():
    """Two frames of the port's sampled scenes at 64^2: frame 0 looks at the
    worker from 2 m, frame 1 over the site."""
    pipe = Pipeline(CFG, device="cpu")
    inputs = pipe.sample_inputs(4, [0, 10])
    w = world.build_world(pipe.roster, inputs.pose)
    h0 = pipe.roster.human_slice[0]
    human = w["inst_pos"][0, h0]
    cam = torch.stack([human + torch.tensor([1.6, 1.2, 0.5]), torch.tensor([13.0, -9.0, 3.5])])
    tgt = torch.stack([human + torch.tensor([0.0, 0.0, 0.9]), torch.tensor([0.0, 0.0, 1.0])])
    M = camera.look_at_matrix(cam, tgt)
    px = camera.pixel_rays(pipe.intr, M).reshape(2, -1, 3)
    kp = world.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"]).reshape(2, -1, 3)
    seg = kp - cam[:, None]
    extra = 2048 - seg.shape[1]
    gen = torch.Generator().manual_seed(0)
    aim = (torch.rand(2, extra, 3, generator=gen) - 0.5) * torch.tensor([24.0, 24.0, 6.0])
    ranged = torch.cat([seg, aim + torch.tensor([0.0, 0.0, 2.0]) - cam[:, None]], dim=1)
    return pipe, w, cam, px, ranged


@pytest.fixture(scope="module")
def jax_sweeps(scene):
    """The JAX mesh sweep (tiles of 32 x 32 on the grid) on both ray sets."""
    pipe, w, cam, px, ranged = scene
    mesh = jmesh.make_mesh_caster(jworld.make_roster(CFG.scene), grid_hw=(RES, RES))
    jw = {k: jnp.asarray(w[k].numpy()) for k in ("inst_rot", "inst_pos", "prim_rot", "prim_pos")}
    run = jax.jit(jax.vmap(mesh))
    out = {name: np.asarray(run(jw, jnp.asarray(cam.numpy()), jnp.asarray(rays.numpy())))
           for name, rays in (("grid", px), ("ranged", ranged))}
    return mesh, out


def _agree(mine, ref, min_hits):
    tm, cm = (x.numpy() for x in raycast._unpack(mine))
    tr, cr = (x.numpy() for x in raycast._unpack(torch.as_tensor(np.array(ref))))
    hm, hr = tm < raycast.INF * 0.99, tr < raycast.INF * 0.99
    both = hm & hr
    assert (hm == hr).mean() > 0.999
    assert both.sum() >= min_hits
    assert np.abs(tm[both] - tr[both]).max() < 1e-3
    np.testing.assert_array_equal(cm[both], cr[both])
    return cm[both] - 2


def test_mesh_sweep_matches_jax(scene, jax_sweeps):
    pipe, w, cam, px, ranged = scene
    jm, ref = jax_sweeps
    mesh = meshcast.make_mesh_caster(pipe.roster, grid_hw=(RES, RES))
    assert (mesh.n_blocks, mesh.n_triangles) == (jm.n_blocks, jm.n_triangles)
    np.testing.assert_array_equal(mesh.covered_prims, jm.covered_prims)
    grid = mesh.packed(w, cam, px)
    insts = _agree(grid, ref["grid"], 500)
    h0 = pipe.roster.human_slice[0]
    assert (insts == h0).sum() > 50  # the skinned worker is in view
    # The square tiles are a permutation of the rays: the contiguous path
    # on the same rays gives the same hits, bit for bit (a miss keeps the
    # code of whichever block was visited last).
    flat = meshcast.make_mesh_caster(pipe.roster).packed(w, cam, px)
    hit = raycast._unpack(grid)[0] < raycast.INF * 0.99
    assert torch.equal(hit, raycast._unpack(flat)[0] < raycast.INF * 0.99)
    assert torch.equal(grid.view(torch.int32)[hit], flat.view(torch.int32)[hit])
    _agree(mesh.packed(w, cam, ranged), ref["ranged"], 300)


def test_masked_caster_and_schedule_leave_out_the_meshed_prims(scene):
    pipe, w, cam, px, _ = scene
    covered = meshcast.make_mesh_caster(pipe.roster).covered_prims
    meshed = {i for i, n in enumerate(pipe.roster.inst_class_names)
              if n in meshcast.DEFAULT_CLASSES}
    assert set(np.nonzero(covered)[0]) == {p for p, i in enumerate(pipe.roster.prim_inst)
                                           if i in meshed}
    caster = raycast.Raycaster(pipe.roster, prim_mask=~covered)
    kept = sorted(int(p) for lst in caster.cats.values() for _, idx in lst for p in idx)
    assert kept == list(np.nonzero(~covered)[0])
    si, sf = sweep_kernel.build_schedule(pipe.roster, ~covered)
    assert sorted(si[:, 1].tolist()) == kept
    full_i, full_f = sweep_kernel.build_schedule(pipe.roster)
    rows = np.isin(full_i[:, 1], kept)
    np.testing.assert_array_equal(si, full_i[rows])
    np.testing.assert_array_equal(sf, full_f[rows])
    # No ray of the masked sweep ends on a meshed instance; others are kept.
    inst = caster.fast(w, cam, px)["inst"]
    assert not np.isin(inst.numpy(), list(meshed)).any()
    assert (inst >= 0).sum() > 0


def test_hifi_render_keeps_the_proxy_labels():
    """The same frames through the hifi and the proxy pipelines: center, size
    and euler bit-equal (template labels), keypoint uv too; the silhouettes
    differ."""
    ids = [1, 2]
    with torch.no_grad():
        hifi = Pipeline(CFG, device="cpu", hifi_mesh=True).make_generate_fn()(6, ids)
        proxy = Pipeline(CFG, device="cpu").make_generate_fn()(6, ids)
    for f in ("center", "size", "euler_deg", "kpt_uv", "kpt_in_image", "camera_pose7"):
        assert torch.equal(getattr(hifi, f), getattr(proxy, f)), f
    assert not torch.equal(hifi.instance, proxy.instance)
    assert (hifi.instance == proxy.instance).float().mean() > 0.5
