"""The port's last render helpers against the JAX package's:
``raycast.occlusion_ts`` (the nearest hit of any other instance along
unnormalized cam -> keypoint segments), ``annotate.pointcloud_xyzrgb`` and
``utils/viz``.

Tolerances: occlusion hits agreeing on > 0.999 of the rays and t to rtol
3e-4 on > 0.999 of the common hits (the caster tolerances of
tests/test_torch_raycast.py: ulp flips on grazing quadric silhouettes);
the point cloud's xyz to 1e-5 relative (an f32 3 x 3 product in another
order), its RGB and validity exact; the visualizations byte for byte."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.render import annotate as jann
from constructionsceneposeestimation_tpu.render import raycast as jrc
from constructionsceneposeestimation_tpu.sample import placement as jpl
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu.utils import viz as jviz
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.render import annotate, raycast
from constructionsceneposeestimation_tpu_torch.scene import world
from constructionsceneposeestimation_tpu_torch.utils import viz

torch.set_num_threads(2)
JCFG = JConfig()
CAMS = np.array([[9.0, 4.0, 3.0], [-14.0, 8.0, 6.0]], np.float32)


@pytest.fixture(scope="module")
def scene():
    jroster = jworld.make_roster(JCFG.scene)
    jpose = jax.jit(lambda k: jpl.randomize_scene(k, jroster, JCFG.scene, JCFG.randomization,
                                                  articulate_crane=True)[0])(
        jax.random.PRNGKey(9))
    jw = jax.jit(lambda p: jworld.build_world(jroster, p))(jpose)
    roster = world.make_roster(SceneConfig())
    w = world.build_world(roster, convert.scene_pose(jpose, batched=False))
    n = len(CAMS)
    wb = {k: (v.expand((n,) + v.shape[1:]) if v.dim() > 2 and k != "prim_params" else v)
          for k, v in w.items()}
    return jroster, jw, roster, wb


def test_occlusion_ts_matches_jax(scene):
    """Rays of random direction and length (unnormalized) from two cameras,
    each excluding a random instance (or none): t where both hit, and the
    hit sets, as the caster tests hold them."""
    jroster, jw, roster, w = scene
    rng = np.random.RandomState(0)
    B, N, O = len(CAMS), 4000, roster.num_instances
    d = rng.randn(B, N, 3).astype(np.float32)
    d[..., 2] -= 0.6  # most rays hit something
    d *= rng.uniform(0.3, 4.0, (B, N, 1)).astype(np.float32)
    excl = rng.randint(-2, O, (B, N)).astype(np.int32)
    got = raycast.occlusion_ts(w, roster, torch.as_tensor(CAMS), torch.as_tensor(d),
                               torch.as_tensor(excl))
    assert got.shape == (B, N)
    for b in range(B):
        want = np.asarray(jrc.occlusion_ts(jw, jroster, jnp.asarray(CAMS[b]), jnp.asarray(d[b]),
                                           jnp.asarray(excl[b])))
        g = got[b].numpy()
        hit = (want < 1e9) & (g < 1e9)
        assert ((want < 1e9) == (g < 1e9)).mean() > 0.999 and hit.mean() > 0.5
        close = np.abs(g[hit] - want[hit]) <= 3e-4 * want[hit]
        assert close.mean() > 0.999, close.mean()
    # Excluding a ray's own first hit changes it: the exclusion is applied.
    first = raycast.occlusion_ts(w, roster, torch.as_tensor(CAMS), torch.as_tensor(d),
                                 torch.full((B, N), -5, dtype=torch.int32))
    assert (got > first).any()


def test_occlusion_ts_excludes_own_instance():
    """The JAX test of the same name: a segment to a cone's apex is not
    occluded by the cone once it is excluded, and is without exclusion."""
    cfg = SceneConfig(n_cones=1, n_trees=0, n_fence_panels=0)
    roster = world.make_roster(cfg)
    jcfg = JSceneConfig(n_cones=1, n_trees=0, n_fence_panels=0)
    jroster = jworld.make_roster(jcfg)
    jpose = jworld.default_pose(jroster, jcfg)
    w = world.build_world(roster, convert.scene_pose(jpose, batched=False))
    c0 = roster.cone_slice[0]
    cam = torch.tensor([[4.0, 0.0, 5.0]])
    seg = torch.tensor([[[4.0, 0.0, 0.7]]]) - cam[:, None]
    t_excl = raycast.occlusion_ts(w, roster, cam, seg, torch.tensor([[c0]]))
    t_incl = raycast.occlusion_ts(w, roster, cam, seg, torch.tensor([[-5]]))
    assert float(t_excl) > 1.0 and float(t_incl) <= 1.01
    # Unnormalized directions: t scales as 1 / |d|.
    t_half = raycast.occlusion_ts(w, roster, cam, 2.0 * seg, torch.tensor([[-5]]))
    np.testing.assert_allclose(float(t_half) * 2.0, float(t_incl), rtol=1e-5)


def test_pointcloud_xyzrgb_matches_jax():
    cfg = Config(pipeline=PipelineConfig(render_width=64, render_height=48, batch_size=2))
    pipe = Pipeline(cfg, device="cpu")
    batch = pipe.make_generate_fn(include_heatmaps=False)(2, range(2))
    got = annotate.pointcloud_xyzrgb(batch.depth, batch.rgb, pipe.intr, batch.camera_pose7)
    jintr = jcam.intrinsics_from_apertures(cfg.camera.focal_length,
                                           cfg.camera.horizontal_aperture, 64, 48)
    assert got["xyzrgb"].shape == (2, 64 * 48, 6)
    for b in range(2):
        want = jann.pointcloud_xyzrgb(jnp.asarray(batch.depth[b].numpy()),
                                      jnp.asarray(batch.rgb[b].numpy()), jintr,
                                      jnp.asarray(batch.camera_pose7[b].numpy()))
        valid = np.asarray(want["valid"])
        np.testing.assert_array_equal(got["valid"][b].numpy(), valid)
        assert valid.any() and (~valid).any()
        g, r = got["xyzrgb"][b].numpy(), np.asarray(want["xyzrgb"])
        np.testing.assert_array_equal(g[:, 3:], r[:, 3:])
        np.testing.assert_allclose(g[valid, :3], r[valid, :3], rtol=1e-5, atol=1e-5)


def test_viz_matches_jax_byte_for_byte(tmp_path):
    rng = np.random.RandomState(2)
    rgb = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    uv = rng.uniform(-10, 74, (5, 4, 2)).astype(np.float32)
    vis = rng.rand(5, 4) < 0.5
    in_img = vis | (rng.rand(5, 4) < 0.5)
    cls = np.arange(5) * 2
    assert np.array_equal(viz.CLASS_COLORS, jviz.CLASS_COLORS)
    a = viz.overlay_keypoints(rgb, uv, vis, cls, in_img, radius=3)
    assert np.array_equal(a, jviz.overlay_keypoints(rgb, uv, vis, cls, in_img, radius=3))
    assert not np.array_equal(a, rgb)
    hm = rng.rand(6, 12, 16).astype(np.float32)
    for ch in (None, [1, 4]):
        assert np.array_equal(viz.heatmap_overlay(rgb, hm, ch), jviz.heatmap_overlay(rgb, hm, ch))
    viz.save_png(str(tmp_path / "a.png"), a)
    jviz.save_png(str(tmp_path / "b.png"), a)
    data = (tmp_path / "a.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data == (tmp_path / "b.png").read_bytes()
