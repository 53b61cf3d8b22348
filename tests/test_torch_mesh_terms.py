"""The mesh terms' kernel split (``render/meshcast.py``: ``term_tables``,
``plain_mesh_terms``, ``mesh_terms_cuda``, ``terms_gap``), on the CPU.

csrc/meshterms.cu builds each render's ``MeshTerms`` from the static
``TermTables``; it runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it to ``plain_mesh_terms``). Here, on
tests/test_torch_meshsweep.py's two scenes at 64^2: the tables gather
exactly the instance, vertex and bone rows ``MeshCaster.corners`` does,
and corners rebuilt from them in plain PyTorch, one element-wise sum a
corner as the kernel forms them, agree with ``corners()`` to 1e-6 m and
give terms within ``terms_gap``'s bar (chip_smoke.py's
MESH_TERMS_UNITS); ``plain_mesh_terms`` through ``plain_mesh_sweep``
matches the JAX caster (tests/test_torch_meshsweep.py's bars, one JAX
compile); the padding slots give cr = 0 and radius -1; on CPU tensors
``MeshCaster.mesh_terms`` takes the plain version; the wrapper refuses
wrong devices, types, shapes, worlds and ``tri_block`` before any launch,
and hands the entry point one argument a C parameter; chip_smoke.py's
bound counts the stores and each element the kernel loads, once."""

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
POSE = ("inst_rot", "inst_pos", "prim_rot", "prim_pos")
# chip_smoke.py's bar on terms_gap: the kernel's terms within 8 units of
# the plain version's; the plain version itself is within ~1.6 of a float64
# reference on these scenes.
UNITS = 8.0


def _scene(name):
    """tests/test_torch_meshsweep.py's scene: two frames of the port's
    sampled scene at 64^2 (frame 0 looks at the first worker from 2 m,
    frame 1 over the site), its hifi caster on the 64^2 pixel grid, the
    world, cameras and pixel rays."""
    sc = SCENES[name]
    pipe = Pipeline(Config(scene=sc, pipeline=PipelineConfig(render_width=64,
                                                            render_height=64)), device="cpu")
    inputs = pipe.sample_inputs(4, [0, 10])
    w = world.build_world(pipe.roster, inputs.pose)
    human = w["inst_pos"][0, pipe.roster.human_slice[0]]
    cam = torch.stack([human + torch.tensor([1.6, 1.2, 0.5]), torch.tensor([13.0, -9.0, 3.5])])
    tgt = torch.stack([human + torch.tensor([0.0, 0.0, 0.9]), torch.tensor([0.0, 0.0, 1.0])])
    px = camera.pixel_rays(camera.intrinsics_from_apertures(12.0, 25.0, 64, 64),
                           camera.look_at_matrix(cam, tgt)).reshape(2, -1, 3)
    mesh = meshcast.make_mesh_caster(pipe.roster, grid_hw=(64, 64))
    return sc, mesh, w, cam, px


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    return _scene(request.param)


def _rebuilt_corners(mesh, w):
    """Each slot's corners from ``mesh``'s tables alone, as csrc/meshterms.cu
    forms them: R v + p of the block's instance, or the blend of the
    vertex's two bones at the instance's bone rows; element-wise sums."""
    t = mesh._on("cpu")["tables"]
    inst, face0, skin = t.blocks.long().unbind(1)
    faces = t.faces.long()[face0[:, None] + torch.arange(mesh.tri_block)]  # (nb, T, 3)
    bones = t.bone_rows.long()[skin.clamp_min(0)]  # (nb, bones)
    R, p = w["inst_rot"][:, inst, None], w["inst_pos"][:, inst, None]  # (B, nb, 1, ...)
    out = []
    for k in range(3):
        v = faces[..., k]  # (nb, T)
        rigid = (R * t.verts[v][None, :, :, None, :]).sum(-1) + p
        blend = 0.0
        for j in range(2):
            row = torch.gather(bones, 1, t.bone_ids.long()[v, j])  # (nb, T)
            vj = (w["prim_rot"][:, row] * t.v_loc[v, j][None, :, :, None, :]).sum(-1)
            blend = blend + t.weights[v, j][None, ..., None] * (vj + w["prim_pos"][:, row])
        out.append(torch.where((skin >= 0)[None, :, None, None], blend, rigid))
    return tuple(out)


def test_tables_gather_the_corners_rows(scene, monkeypatch):
    """The tables hold each block's instance (its code - 2), its class's
    faces offset into the one vertex index space, each vertex table's rows
    and the worker's bone rows, exactly; corners rebuilt from them agree
    with ``corners()`` to 1e-6 m, and their terms with ``plain_mesh_terms``'
    within the kernel's bar."""
    _, mesh, w, cam, _ = scene
    tab = mesh.tables
    T = mesh.tri_block
    np.testing.assert_array_equal(tab["blocks"][:, 0], mesh.codes - 2)
    b = v0 = f0 = 0
    for c in mesh.classes:
        V = len(c.verts)
        np.testing.assert_array_equal(tab["verts"][v0:v0 + V], c.verts)
        np.testing.assert_array_equal(tab["faces"][f0:f0 + len(c.faces)], c.faces + v0)
        for i in range(len(c.ids)):
            for j in range(c.n_blocks):
                want = (f0 + j * T, -1 if c.skin is None else i)
                assert tuple(tab["blocks"][b, 1:]) == want
                b += 1
        if c.skin is not None:
            for key in ("v_loc", "weights", "bone_ids"):
                np.testing.assert_array_equal(tab[key][v0:v0 + V], c.skin[key])
            np.testing.assert_array_equal(tab["bone_rows"], c.skin["bone_rows"])
        else:
            assert not tab["weights"][v0:v0 + V].any()
        v0, f0 = v0 + V, f0 + len(c.faces)
    assert b == mesh.n_blocks and v0 == len(tab["verts"]) and f0 == len(tab["faces"])
    assert (tab["blocks"][:, 2] >= 0).sum() == sum(c.n_blocks * len(c.ids) for c in mesh.classes
                                                   if c.skin is not None) > 0
    corners = mesh.corners(w)
    rebuilt = _rebuilt_corners(mesh, w)
    for mine, want in zip(rebuilt, corners):
        assert float((mine - want).abs().max()) <= 1e-6
    ref = meshcast.plain_mesh_terms(mesh, w, cam)
    monkeypatch.setattr(mesh, "corners", lambda world: rebuilt)
    gap = meshcast.terms_gap(meshcast.plain_mesh_terms(mesh, w, cam), ref, corners)
    assert max(gap.values()) <= UNITS, gap


def test_terms_gap_measures_a_moved_corner(scene, monkeypatch):
    """``terms_gap`` is 0 between equal terms and grows with a corner moved
    by k ulps of its coordinates' scale: about k units, never 0."""
    _, mesh, w, cam, _ = scene
    corners = mesh.corners(w)
    ref = meshcast.plain_mesh_terms(mesh, w, cam)
    assert max(meshcast.terms_gap(ref, ref, corners).values()) == 0.0
    c0, c1, c2 = corners
    scale = torch.stack([c.abs().amax(-1) for c in corners]).amax(0)[..., None]
    moved = (c0, c1 + 64 * 2.0 ** -23 * scale, c2)
    monkeypatch.setattr(mesh, "corners", lambda world: moved)
    gap = meshcast.terms_gap(meshcast.plain_mesh_terms(mesh, w, cam), ref, corners)
    # au = e2 x s does not read c1.
    assert gap["au"] == 0.0 and min(gap[k] for k in ("cr", "qv", "tn", "centre", "radius")) > 0
    assert 8.0 < max(gap.values()) < 400.0, gap


def _jax_packed(sc, w, cam, rays, **kw):
    mesh = jmesh.make_mesh_caster(jworld.make_roster(sc), **kw)
    jw = {k: jnp.asarray(w[k].numpy()) for k in POSE}
    return np.asarray(jax.jit(jax.vmap(mesh))(jw, jnp.asarray(cam.numpy()),
                                              jnp.asarray(rays.numpy())))


def test_plain_terms_sweep_matches_jax():
    """``plain_mesh_terms`` through ``plain_mesh_sweep`` on the default
    scene's 64^2 pixel tiles against the JAX caster (one compile), with
    tests/test_torch_meshsweep.py's bars: hits agree on > 0.999 of the
    rays, |dt| < 1e-3 m and the instance exact on common hits."""
    sc, mesh, w, cam, px = _scene("default")
    m = meshcast.plain_mesh_terms(mesh, w, cam)
    mine = meshcast.plain_mesh_sweep(m.terms, m.lo, m.hi, mesh._on("cpu")["codes"], cam, px,
                                     mesh.layout(px.shape[1]))
    tm, cm = (x.numpy() for x in raycast._unpack(mine))
    tr, cr = (x.numpy() for x in raycast._unpack(torch.from_numpy(
        _jax_packed(sc, w, cam, px, grid_hw=(64, 64)).copy())))
    hm, hr = tm < raycast.INF * 0.99, tr < raycast.INF * 0.99
    both = hm & hr
    assert (hm == hr).mean() > 0.999 and both.sum() >= 500
    assert np.abs(tm[both] - tr[both]).max() < 1e-3
    np.testing.assert_array_equal(cm[both], cr[both])


def test_padding_slots_give_zero_cr_and_no_sphere(scene):
    """Each instance's slots past its class's faces hold cr = 0 exactly and
    radius -1, as do the worker's few faces whose corners coincide (its
    capsules' poles); every other slot a radius > 0."""
    _, mesh, w, cam, _ = scene
    m = meshcast.plain_mesh_terms(mesh, w, cam)
    T = mesh.tri_block
    pad = torch.zeros(mesh.n_blocks, T, dtype=torch.bool)
    b = 0
    for c in mesh.classes:
        slot = torch.arange(c.n_blocks * T).reshape(c.n_blocks, T)
        for _ in c.ids:
            pad[b:b + c.n_blocks] = slot >= c.n_faces
            b += c.n_blocks
    flat = (m.terms[:, :, :3] == 0).all(2)  # (B, nb, T)
    pad = pad.expand_as(flat)
    assert int(pad.sum()) > 0 and bool(flat[pad].all())
    skinned = torch.as_tensor(mesh.tables["blocks"][:, 2] >= 0)
    assert not bool((flat & ~pad)[:, ~skinned].any())
    radius = m.spheres[:, :, 3]
    assert bool((radius[flat] == -1.0).all()) and bool((radius[~flat] > 0).all())


def test_mesh_terms_on_cpu_takes_the_plain_version(scene, monkeypatch):
    """A CPU origin never reaches the kernel: ``mesh_terms`` is
    ``plain_mesh_terms`` bit for bit, for that very origin tensor."""
    _, mesh, w, cam, _ = scene
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("a CPU tensor was launched"))
    before = meshcast.mesh_terms_cuda.launches, meshcast.plain_mesh_terms.card_calls
    m, want = mesh.mesh_terms(w, cam), meshcast.plain_mesh_terms(mesh, w, cam)
    assert m.origin is cam
    for got, ref in zip(m[:4], want[:4]):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert (meshcast.mesh_terms_cuda.launches, meshcast.plain_mesh_terms.card_calls) == before


def _wrapper_args(mesh, w, cam):
    return dict(tables=mesh._on("cpu")["tables"], **{k: w[k] for k in POSE}, ray_o=cam,
                tri_block=mesh.tri_block)


REFUSALS = {
    "tri_block": (lambda a: dict(tri_block=256), "tri_block"),
    "device": (lambda a: {}, "expected a CUDA tensor"),
    "dtype": (lambda a: dict(inst_rot=a["inst_rot"].double()), "terms inst_rot"),
    "table dtype": (lambda a: dict(tables=a["tables"]._replace(
        blocks=a["tables"].blocks.long())), "terms blocks"),
    "shape": (lambda a: dict(ray_o=a["ray_o"][:, :2]), "terms ray_o"),
    "frames": (lambda a: dict(prim_pos=a["prim_pos"][:1]), "terms prim_pos"),
    "instances": (lambda a: dict(inst_rot=a["inst_rot"][:, :3], inst_pos=a["inst_pos"][:, :3]),
                  "instances"),
    "bones": (lambda a: dict(tables=a["tables"]._replace(bone_rows=torch.zeros(
        1, meshcast.MAX_BONES + 1, dtype=torch.int32))), "bones"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_before_any_launch(scene, monkeypatch, case):
    """A CPU tensor, a wrong type or shape, a world without the tables'
    rows, too many bones or a ``tri_block`` other than KERNEL_TRI_BLOCK
    raise before a launch."""
    _, mesh, w, cam, _ = scene
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("launched"))
    args = _wrapper_args(mesh, w, cam)
    change, match = REFUSALS[case]
    before = meshcast.mesh_terms_cuda.launches
    with pytest.raises(ValueError, match=match):
        meshcast.mesh_terms_cuda(**{**args, **change(args)})
    assert meshcast.mesh_terms_cuda.launches == before


def test_wrapper_passes_the_entry_points_arguments(scene, monkeypatch):
    """``mesh_terms_cuda`` hands ``cspe_mesh_terms`` one argument for each of
    its C parameters but the stream, tensors where it takes a pointer and
    ints where it takes an int, and returns the outputs it passed in the
    ``MeshTerms`` layout, for the origin it was given."""
    _, mesh, w, cam, _ = scene
    seen = []
    monkeypatch.setattr(kernels, "check_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "launch", lambda name, *args: seen.append((name, args)))
    before = meshcast.mesh_terms_cuda.launches
    m = meshcast.mesh_terms_cuda(**_wrapper_args(mesh, w, cam))
    (name, args), = seen
    sig = kernels.SIGNATURES[name][:-1]  # the stream is the last
    assert len(args) == len(sig)
    for a, t in zip(args, sig):
        assert isinstance(a, int) if t is kernels._I else torch.is_tensor(a)
    nb, B = mesh.n_blocks, 2
    ints = [a for a in args if isinstance(a, int)]
    assert ints == [B, nb, w["inst_rot"].shape[1], w["prim_rot"].shape[1],
                    mesh.tables["bone_rows"].shape[1]]
    assert all(a is b for a, b in zip(args[-4:], (m.terms, m.spheres, m.lo, m.hi)))
    assert m.origin is cam
    assert m.terms.shape == (B, nb, meshcast.N_TERMS, meshcast.KERNEL_TRI_BLOCK)
    assert m.spheres.shape == (B, nb, 4, meshcast.KERNEL_TRI_BLOCK)
    assert m.lo.shape == m.hi.shape == (B, nb, 3)
    assert meshcast.mesh_terms_cuda.launches == before + 1


def _kernel_reads(tab, n, n_inst, n_prims):
    """The distinct input elements csrc/meshterms.cu loads for ``n`` frames,
    followed load by load through its code, as flat indices a table."""
    blocks, faces = tab["blocks"], tab["faces"]
    n_bones = tab["bone_rows"].shape[1]
    T = meshcast.KERNEL_TRI_BLOCK
    seen = {k: [] for k in ("blocks", "faces", "verts", "v_loc", "weights", "bone_ids",
                            "bone_rows", "inst_rot", "inst_pos", "prim_rot", "prim_pos", "ray_o")}
    frames = np.arange(n)[:, None]
    for k, (inst, face0, skin) in enumerate(blocks):
        seen["blocks"].append(3 * k + np.arange(3))
        rows = face0 + np.arange(T)
        seen["faces"].append((3 * rows[:, None] + np.arange(3)).ravel())
        v = faces[rows].ravel()
        if skin < 0:
            row = frames * n_inst + inst
            seen["inst_rot"].append((9 * row + np.arange(9)).ravel())
            seen["inst_pos"].append((3 * row + np.arange(3)).ravel())
            seen["verts"].append((3 * v[:, None] + np.arange(3)).ravel())
            continue
        bone = tab["bone_rows"][skin]
        seen["bone_rows"].append(skin * n_bones + np.arange(n_bones))
        row = frames * n_prims + bone
        seen["prim_rot"].append((9 * row[..., None] + np.arange(9)).ravel())
        seen["prim_pos"].append((3 * row[..., None] + np.arange(3)).ravel())
        q = (2 * v[:, None] + np.arange(2)).ravel()
        seen["v_loc"].append((3 * q[:, None] + np.arange(3)).ravel())
        seen["weights"].append(q)
        seen["bone_ids"].append(q)
    seen["ray_o"].append(np.arange(3 * n))
    return {k: len(np.unique(np.concatenate(x))) for k, x in seen.items() if x}


def test_terms_bound_counts_what_the_kernel_reads(scene):
    """chip_smoke.py's ``mesh_terms_bytes``, the bytes behind the terms
    kernel's bound, is its stores plus each element the kernel loads, once:
    no table row no block reads, no rigid vertex's zero skin, no pose row of
    an instance or primitive no block reads."""
    import chip_smoke
    _, mesh, w, cam, _ = scene
    m = meshcast.plain_mesh_terms(mesh, w, cam)
    n = m.terms.shape[0]
    reads = _kernel_reads(mesh.tables, n, w["inst_rot"].shape[1], w["prim_rot"].shape[1])
    stores = sum(t.numel() * t.element_size() for t in m[:4])
    assert chip_smoke.mesh_terms_bytes(mesh.tables, m, n) == stores + 4 * sum(reads.values())
    whole = sum(a.size for a in mesh.tables.values()) + sum(w[k].numel() for k in POSE) + 3 * n
    assert sum(reads.values()) < whole
