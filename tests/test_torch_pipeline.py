"""The slice as a whole: the port's annotation pass and generate step
against the JAX package's per-frame body (``Pipeline._one_frame``:
build_world, render_frame on the jnp tier, frame_heatmaps) on the same
sampled scenes, cameras and lights; determinism and batch independence of
``generate``; ``quality_stats``.

Tolerances (float32 on both sides; see the module docstrings of
test_torch_raycast / test_torch_rgb / test_torch_heatmap for each source):
depth rtol 3e-4 where both are finite, finite masks and instance maps
agree on > 0.999 of pixels; centre and size atol 1e-4 m; euler 1e-2 deg;
keypoint uv 1e-3 px; camera pose 1e-5; in-image flags exact; visibility
>= 0.99; pixel counts, point-cloud counts and 2D boxes exact where the
instance maps agree, else bounded by the mismatched pixels; heatmaps atol
2e-4; RGB with hash noise on: means within 1.0 and stds within 2.0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.ops import heatmap as jhm
from constructionsceneposeestimation_tpu.render import annotate as jann
from constructionsceneposeestimation_tpu.render import raycast as jrc
from constructionsceneposeestimation_tpu.render import shading as jsh
from constructionsceneposeestimation_tpu.sample import camera_sampler as jcs
from constructionsceneposeestimation_tpu.sample import lighting as jlit
from constructionsceneposeestimation_tpu.sample import placement as jpl
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import (FrameBatch,
                                                                         FrameInputs, Pipeline,
                                                                         quality_stats)

torch.set_num_threads(2)
RES = 64
CFG = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=4))
JCFG = JConfig()
FIELDS = [f for f in FrameBatch._fields if f not in ("frame_id", "heatmaps")]


@pytest.fixture(scope="module")
def jax_render():
    """The JAX per-frame body, vmapped over frames."""
    roster = jworld.make_roster(JCFG.scene)
    caster = jrc.make_raycaster(roster, scene_cfg=JCFG.scene)
    intr = jcam.intrinsics_from_apertures(12.0, 25.0, RES, RES)
    ch = jnp.asarray(roster.inst_kpt_channel)

    def one(pose, cam, tgt, lit):
        w = jworld.build_world(roster, pose)
        ann = jann.render_frame(roster, caster, w, cam, tgt, intr, lighting=lit,
                                far_clip=JCFG.camera.clipping[1])
        hms = jhm.frame_heatmaps(ann.kpt_uv, ann.kpt_visible, ch, 71, RES // 4, RES // 4,
                                 JCFG.pipeline.heatmap_sigma, JCFG.pipeline.heatmap_stride)
        return ann, hms

    return roster, jax.jit(jax.vmap(one))


@pytest.fixture(scope="module")
def pipe():
    return Pipeline(CFG, device="cpu")


def _compare(mine: FrameBatch, ref, ref_hms):
    g = {f: getattr(mine, f).numpy() for f in FrameBatch._fields}
    r = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
    d_m, d_r = g["depth"], r["depth"]
    assert (np.isfinite(d_m) == np.isfinite(d_r)).mean() > 0.999
    fin = np.isfinite(d_m) & np.isfinite(d_r)
    np.testing.assert_allclose(d_m[fin], d_r[fin], rtol=3e-4)
    assert (g["instance"] == r["instance"]).mean() > 0.999
    for f, tol in (("center", 1e-4), ("size", 1e-4), ("euler_deg", 1e-2), ("kpt_uv", 1e-3),
                   ("camera_pose7", 1e-5)):
        np.testing.assert_allclose(g[f], r[f], atol=tol, err_msg=f)
    np.testing.assert_array_equal(g["kpt_in_image"], r["kpt_in_image"])
    assert (g["kpt_visible"] == r["kpt_visible"]).mean() >= 0.99
    for b in range(len(d_m)):
        n_mis = int((g["instance"][b] != r["instance"][b]).sum())
        assert abs(int(g["pointcloud_count"][b]) - int(r["pointcloud_count"][b])) <= n_mis
        dc = np.abs(g["inst_pixel_count"][b].astype(int) - r["inst_pixel_count"][b])
        assert dc.sum() <= 2 * n_mis
        same = dc == 0
        np.testing.assert_array_equal(g["bbox2d"][b][same & (n_mis == 0)],
                                      r["bbox2d"][b][same & (n_mis == 0)])
        np.testing.assert_array_equal(g["inst_visible"][b], g["inst_pixel_count"][b] > 0)
    rgb_m, rgb_r = g["rgb"].astype(np.float32), r["rgb"].astype(np.float32)
    assert abs(rgb_m.mean() - rgb_r.mean()) < 1.0 and abs(rgb_m.std() - rgb_r.std()) < 2.0
    np.testing.assert_allclose(g["heatmaps"], np.asarray(ref_hms), atol=2e-4)
    assert g["heatmaps"].max() > 0.9


def test_render_matches_reference_on_reference_samples(jax_render, pipe):
    """Scenes, cameras and lights sampled by the JAX package, handed to both
    through ``convert``."""
    jroster, render = jax_render
    B = 3
    poses = jax.jit(jax.vmap(lambda k: jpl.randomize_scene(
        k, jroster, JCFG.scene, JCFG.randomization, articulate_crane=True)[0]))(
        jax.random.split(jax.random.PRNGKey(3), B))
    cam, tgt = jcs.sample_camera_batch(jax.random.PRNGKey(11), B, JCFG.camera)
    lits = jax.vmap(jlit.sample_lighting)(jax.random.split(jax.random.PRNGKey(12), B))
    ann, hms = render(poses, cam, tgt, lits)
    inputs = FrameInputs(convert.scene_pose(poses), *convert.cameras(cam, tgt),
                         convert.lighting(lits))
    mine = pipe.render(torch.arange(B, dtype=torch.int32), inputs)
    _compare(mine, ann, hms)


def test_generate_matches_reference_on_its_own_samples(jax_render, pipe):
    """The port's generate step, with its own generators, against the JAX
    render of the very scenes, cameras and lights it sampled."""
    _, render = jax_render
    fids = list(range(8, 12))  # two cadence groups
    batch = pipe.make_generate_fn()(5, fids)
    inputs = pipe.sample_inputs(5, fids)
    pose = jworld.ScenePose(*(None if f is None else jnp.asarray(f.numpy())
                              for f in inputs.pose))
    lit = jsh.Lighting(*(jnp.asarray(f.numpy()) for f in inputs.lighting))
    ann, hms = render(pose, jnp.asarray(inputs.cam_pos.numpy()),
                      jnp.asarray(inputs.target.numpy()), lit)
    _compare(batch, ann, hms)
    np.testing.assert_array_equal(batch.frame_id.numpy(), fids)
    # The cadence: frames 8, 9 share a scene, 10, 11 share the next one.
    pos = inputs.pose.positions
    assert torch.equal(pos[0], pos[1]) and torch.equal(pos[2], pos[3])
    assert not torch.equal(pos[1], pos[2])
    assert not torch.equal(inputs.cam_pos[0], inputs.cam_pos[1])


def test_entry_points_default_to_the_card():
    """``Pipeline`` and ``make_model`` run on the card unless the caller
    passes ``device="cpu"``; building a Pipeline touches no device."""
    import inspect

    from constructionsceneposeestimation_tpu_torch.models import pose_net

    assert Pipeline(CFG).device.type == "cuda"
    assert inspect.signature(pose_net.make_model).parameters["device"].default == "cuda"


def test_generate_deterministic_and_batch_independent(pipe):
    gen = pipe.make_generate_fn()
    a = gen(7, range(8, 12))
    b = gen(7, range(8, 12))
    for f in FrameBatch._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    # The same frames inside a wider batch (other groups, other positions).
    wide = gen(7, range(3, 15))
    for f in FrameBatch._fields:
        assert torch.equal(getattr(wide, f)[5:9], getattr(a, f)), f
    other = gen(8, range(8, 12))
    assert not torch.equal(other.rgb, a.rgb)


def test_generate_fields_and_quality_stats(pipe):
    batch = pipe.make_generate_fn()(1, range(4))
    O = pipe.roster.num_instances
    K = pipe.roster.inst_kpts.shape[1]
    expect = {"frame_id": ((4,), torch.int32), "rgb": ((4, RES, RES, 3), torch.uint8),
              "depth": ((4, RES, RES), torch.float32), "instance": ((4, RES, RES), torch.int32),
              "camera_pose7": ((4, 7), torch.float32), "inst_visible": ((4, O), torch.bool),
              "inst_pixel_count": ((4, O), torch.int32), "bbox2d": ((4, O, 4), torch.int32),
              "center": ((4, O, 3), torch.float32), "size": ((4, O, 3), torch.float32),
              "euler_deg": ((4, O, 3), torch.float32), "kpt_uv": ((4, O, K, 2), torch.float32),
              "kpt_visible": ((4, O, K), torch.bool), "kpt_in_image": ((4, O, K), torch.bool),
              "heatmaps": ((4, 71, RES // 4, RES // 4), torch.float32),
              "pointcloud_count": ((4,), torch.int32)}
    assert list(expect) == list(FrameBatch._fields)
    for f, (shape, dtype) in expect.items():
        v = getattr(batch, f)
        assert tuple(v.shape) == shape and v.dtype == dtype, f
    q = quality_stats(batch, CFG.quality.min_pointcloud_points)
    n_obj = batch.inst_visible.sum(-1)
    assert int(q["total_frames"]) == 4
    assert int(q["objects_total"]) == int(n_obj.sum())
    assert int(q["labels_valid"]) + int(q["labels_empty"]) == 4
    assert (int(q["pointcloud_valid"]) + int(q["pointcloud_insufficient"])
            + int(q["pointcloud_empty"])) == 4
    no_hm = pipe.make_generate_fn(include_heatmaps=False)(1, range(4))
    assert no_hm.heatmaps.shape == (4, 0, RES // 4, RES // 4)
    assert torch.equal(no_hm.depth, batch.depth)
