"""The PyTorch port's copied modules (config, taxonomy, assets), its
roster, ``convert`` and its import boundary, held against the JAX package.

Copies are compared for exact equality: they are the same data."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from constructionsceneposeestimation_tpu import config as jconfig
from constructionsceneposeestimation_tpu.scene import assets as jassets
from constructionsceneposeestimation_tpu.scene import taxonomy as jtaxonomy
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu.render import shading as jsh
from constructionsceneposeestimation_tpu_torch import config, convert
from constructionsceneposeestimation_tpu_torch.scene import assets, taxonomy
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def test_config_equal():
    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(jconfig.Config())
    for name in ("CameraConfig", "QualityConfig", "RandomizationConfig", "LightingConfig",
                 "SceneConfig", "PipelineConfig", "TrainConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(config, name))]
                == [f.name for f in dataclasses.fields(getattr(jconfig, name))])


def test_taxonomy_equal():
    for name in ("CONSTRUCTION_CLASS", "CLASS_ID_TO_NAME", "NUM_CLASSES", "CRANE_PART_CHILD_MAP",
                 "CRANE_ROOT", "DUMPER_ROOT", "HUMAN_ROOT", "CONE_ROOT_PREFIX",
                 "TREE_ROOT_PREFIX", "FENCE_ROOT_PREFIX", "OBJECT_ROOT_PATTERNS"):
        assert getattr(taxonomy, name) == getattr(jtaxonomy, name), name
    assert list(taxonomy.CONSTRUCTION_CLASS) == list(jtaxonomy.CONSTRUCTION_CLASS)
    paths = [jtaxonomy.CRANE_ROOT + "/s104hz01ka_sw/mesh", jtaxonomy.DUMPER_ROOT + "/x",
             "/World/Tree/Tree_03/leaf", jtaxonomy.CONE_ROOT_PREFIX + "_02/m",
             jtaxonomy.FENCE_ROOT_PREFIX + "2_07/panel", "/World/GroundPlane/DHGen/body",
             "/World/x/pk7_boom_arm", "/World/nothing"]
    for p in paths:
        assert taxonomy.get_object_root(p) == jtaxonomy.get_object_root(p), p


def test_assets_equal():
    assert assets.NUM_KEYPOINT_CHANNELS == jassets.NUM_KEYPOINT_CHANNELS == 71
    assert assets.MAX_KEYPOINTS_PER_OBJECT == jassets.MAX_KEYPOINTS_PER_OBJECT
    assert assets.keypoint_channel_table() == jassets.keypoint_channel_table()
    np.testing.assert_array_equal(assets.CANONICAL_COCO, jassets.CANONICAL_COCO)
    assert assets.HUMAN_SEGMENTS == jassets.HUMAN_SEGMENTS
    mine, ref = assets.all_templates(), jassets.all_templates()
    assert list(mine) == list(ref)
    for name in ref:
        for f in dataclasses.fields(ref[name]):
            a, b = getattr(mine[name], f.name), getattr(ref[name], f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f.name}")
            else:
                assert a == b, f"{name}.{f.name}"


@pytest.mark.parametrize("scene", [
    dict(), dict(n_cones=6, n_trees=2, n_fence_panels=8), dict(n_humans=2, n_dumpers=2)])
def test_roster_equal(scene):
    mine = convert.roster_arrays(world.make_roster(config.SceneConfig(**scene)))
    ref = convert.roster_arrays(jworld.make_roster(jconfig.SceneConfig(**scene)))
    assert mine.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert mine[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
        else:
            assert mine[k] == ref[k], k


def test_convert_scene_pose_and_lighting():
    jr = jworld.make_roster(jconfig.SceneConfig())
    jpose = jworld.default_pose(jr, jconfig.SceneConfig())
    pose = convert.scene_pose(jpose, batched=False)
    for f in world.ScenePose._fields:
        got = getattr(pose, f)
        assert got.shape[0] == 1 and got.dtype == torch.float32, f
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(getattr(jpose, f)), err_msg=f)
    mine = world.default_pose(world.make_roster(config.SceneConfig()), config.SceneConfig())
    for f in world.ScenePose._fields:
        np.testing.assert_array_equal(getattr(mine, f).numpy(), getattr(pose, f).numpy(),
                                      err_msg=f)
    lit = jsh.default_lighting()._replace(tex_phase=jnp.float32(0.3))
    got = convert.lighting(lit, batched=False)
    for f in got._fields:
        np.testing.assert_array_equal(got._asdict()[f][0].numpy(),
                                      np.asarray(getattr(lit, f), np.float32))
    cam, tgt = convert.cameras(np.ones((2, 3)), np.zeros((2, 3)))
    assert cam.shape == tgt.shape == (2, 3) and cam.dtype == torch.float32


def _body(path):
    """A module's text after its docstring."""
    import ast
    src = path.read_text()
    doc = ast.get_docstring(ast.parse(src), clean=False)
    return src[src.index(doc) + len(doc) + 3:]


def test_tracking_is_a_copy():
    """``eval/tracking.py`` is the JAX module's code, text for text, under a
    docstring of its own."""
    assert _body(ROOT / "constructionsceneposeestimation_tpu_torch" / "eval" / "tracking.py") \
        == _body(ROOT / "constructionsceneposeestimation_tpu" / "eval" / "tracking.py")


def test_sequence_metrics_is_a_copy():
    """``eval/sequence_metrics.py`` likewise."""
    name = ("eval", "sequence_metrics.py")
    assert _body(ROOT.joinpath("constructionsceneposeestimation_tpu_torch", *name)) \
        == _body(ROOT.joinpath("constructionsceneposeestimation_tpu", *name))


def test_port_imports_no_jax():
    """Importing the port, running one tiny generate, its point cloud, one
    tiny evaluation step, the ``generate`` command to shards (i.i.d., clips,
    the hifi and the image-texture tiers), read back, ``infer`` on freshly
    initialized full-width checkpoints and ``seq-eval`` on its records,
    ``render_frame``'s analytic-normal, sun-shadow and flat tiers (the
    exact caster, the shadow sweep, the hifi caster's), a flat
    ``Pipeline``, the profiling helpers and ``bench`` at 64^2, with the
    multi-GPU and visualization modules imported, load neither jax nor the
    JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig\n"
        "from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline\n"
        "from constructionsceneposeestimation_tpu_torch.eval import pipeline as ev\n"
        "from constructionsceneposeestimation_tpu_torch.models import pose_net\n"
        "import constructionsceneposeestimation_tpu_torch.convert\n"
        "import constructionsceneposeestimation_tpu_torch.ops.peak_kernel\n"
        "cfg = Config(pipeline=PipelineConfig(render_width=64, render_height=64))\n"
        "pipe = Pipeline(cfg, device='cpu')\n"
        "b = pipe.make_generate_fn()(0, range(2))\n"
        "assert b.rgb.shape == (2, 64, 64, 3)\n"
        "from constructionsceneposeestimation_tpu_torch.render import annotate\n"
        "pc = annotate.pointcloud_xyzrgb(b.depth, b.rgb, pipe.intr, b.camera_pose7)\n"
        "assert pc['xyzrgb'].shape == (2, 64 * 64, 6)\n"
        "from constructionsceneposeestimation_tpu_torch.render import meshcast\n"
        "from constructionsceneposeestimation_tpu_torch.scene import world as wm\n"
        "from constructionsceneposeestimation_tpu_torch.utils import profiling\n"
        "inp = pipe.sample_inputs(0, range(2))\n"
        "w = wm.build_world(pipe.roster, inp.pose)\n"
        "for caster in (pipe.caster, meshcast.HifiCaster(pipe.roster, grid_hw=(64, 64))):\n"
        "    with profiling.annotate('tiers'):\n"
        "        a = annotate.render_frame(pipe.roster, caster, pipe.sweeper, w, inp.cam_pos,\n"
        "            inp.target, pipe.intr, inp.lighting, analytic_normals=True,\n"
        "            sun_shadows=True, procedural_textures=False)\n"
        "    assert a.rgb.shape == (2, 64, 64, 3)\n"
        "fb = Pipeline(cfg, device='cpu', procedural_textures=False).make_generate_fn()(0, range(2))\n"
        "assert torch.equal(fb.instance, b.instance)\n"
        "import constructionsceneposeestimation_tpu_torch.parallel.mesh\n"
        "import constructionsceneposeestimation_tpu_torch.utils.viz\n"
        "model = pose_net.make_model(lite=True, device='cpu', dtype=torch.float32)\n"
        "out, hm = ev.evaluate_model(model, b, pipe.roster, pipe.intr, 4.0)\n"
        "assert hm.shape == b.heatmaps.shape and bool(torch.isfinite(hm).all())\n"
        "assert all(bool(torch.isfinite(v).all()) for r in out.values() for v in r.values())\n"
        "import tempfile, contextlib, io\n"
        "from constructionsceneposeestimation_tpu_torch import cli\n"
        "from constructionsceneposeestimation_tpu_torch.io import dataset_writer, reader\n"
        "d = tempfile.mkdtemp()\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    cli.main(['generate', '--device', 'cpu', '--size', '64', '--frames', '2',\n"
        "              '--batch', '2', '--format', 'packed', '--heatmaps', '--out', d])\n"
        "assert len(reader.ShardDataset(d)) == 2\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    for extra in (['--sequence-len', '2', '--frames', '2'], ['--hifi', '--frames', '1'],\n"
        "                  ['--image-textures', '--frames', '2']):\n"
        "        cli.main(['generate', '--device', 'cpu', '--size', '64', '--batch', '2',\n"
        "                  '--format', 'packed', '--out', f'{d}/{extra[0]}', *extra])\n"
        "from constructionsceneposeestimation_tpu_torch.train import (checkpoint, crop_loop,\n"
        "    detect_loop, loop)\n"
        "for name, m in (('det', detect_loop.make_detect_model(device='cpu')),\n"
        "                ('crop', crop_loop.make_crop_model('dumper', device='cpu'))):\n"
        "    checkpoint.CheckpointManager(f'{d}/{name}').maybe_save(\n"
        "        loop.create_train_state(cfg, m), force=True)\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    cli.main(['infer', '--device', 'cpu', '--size', '64', '--frames', '2', '--batch',\n"
        "              '2', '--crop', '32', '--det-ckpt', f'{d}/det', '--crop-ckpt',\n"
        "              f'{d}/crop', '--out', f'{d}/poses.jsonl'])\n"
        "assert len(open(f'{d}/poses.jsonl').readlines()) == 2\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    cli.main(['seq-eval', '--poses', f'{d}/poses.jsonl', '--sequence-len', '2'])\n"
        "assert out.getvalue().startswith('sequence eval (1 clips x 2 frames, 2 frames):')\n"
        "from constructionsceneposeestimation_tpu_torch import bench\n"
        "bench.run(batch=2, steps=1, size=64, device='cpu')\n"
        "import shutil; shutil.rmtree(d)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m.startswith('constructionsceneposeestimation_tpu.')\n"
        "       or m == 'constructionsceneposeestimation_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_port_sources_never_import_jax():
    pkg = ROOT / "constructionsceneposeestimation_tpu_torch"
    for f in pkg.rglob("*.py"):
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))
                        or "constructionsceneposeestimation_tpu." in s and "import" in s
                        and "_tpu_torch" not in s), f"{f}: {s}"
