"""The port's io modules against the JAX package's: the dataset writer's
file tree, the packed shards and their manifest, the shard reader, and the
fastio library that the port builds for itself.

One ``FrameBatch`` from the port's CPU ``generate`` (64^2, a small scene),
taken to numpy by ``HostCopy``, goes to both packages' writers: the JAX
writers only call ``np.asarray`` on its fields. The trees must be equal
byte for byte, logs included; shards are compared array by array (zip
members carry write times), their manifests byte for byte."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.config import PipelineConfig as JPipelineConfig
from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.io import dataset_writer as jdw
from constructionsceneposeestimation_tpu.io import native as jnative
from constructionsceneposeestimation_tpu.io import packed as jpacked
from constructionsceneposeestimation_tpu.io import reader as jreader
from constructionsceneposeestimation_tpu.io import schema as jschema
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.io import (dataset_writer, native, packed, reader,
                                                          resume, schema)
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import (FrameBatch, HostCopy,
                                                                         Pipeline)
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
RES, B = 64, 3
SCENE = dict(n_cones=2, n_trees=1, n_fence_panels=4)


def _cfgs(bug_compatible=False):
    pc = dict(render_width=RES, render_height=RES, batch_size=B,
              bug_compatible_schema=bug_compatible)
    return (Config(scene=SceneConfig(**SCENE), pipeline=PipelineConfig(**pc)),
            JConfig(scene=JSceneConfig(**SCENE), pipeline=JPipelineConfig(**pc)))


@pytest.fixture(scope="module")
def host_batch():
    """Frames 0-2 from the port's CPU generate, heatmaps included, as numpy."""
    cfg, _ = _cfgs()
    with torch.no_grad():
        batch = Pipeline(cfg, device="cpu").make_generate_fn()(0, range(B))
    return HostCopy(batch).wait()


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_host_copy_of_a_cpu_batch_is_numpy(host_batch):
    assert isinstance(host_batch, FrameBatch)
    assert all(isinstance(v, np.ndarray) for v in host_batch)
    assert host_batch.rgb.shape == (B, RES, RES, 3) and host_batch.rgb.dtype == np.uint8
    assert host_batch.inst_visible.dtype == np.bool_
    np.testing.assert_array_equal(host_batch.frame_id, np.arange(B))


@pytest.mark.parametrize("bug_compatible", [False, True])
def test_writer_tree_equals_jax_bytes(tmp_path, host_batch, bug_compatible):
    cfg, jcfg = _cfgs(bug_compatible)
    roots = {}
    for tag, mod, c, roster in (("a", jdw, jcfg, jworld.make_roster(jcfg.scene)),
                                ("b", dataset_writer, cfg, world.make_roster(cfg.scene))):
        roots[tag] = str(tmp_path / tag / "ds")  # quality.py logs the base name
        w = mod.DatasetWriter(c, root=roots[tag])
        w.write_batch(host_batch, roster)
        # A second batch: the padded repeat of the last frame, as generate
        # writes a short last chunk.
        w.write_batch(FrameBatch(*(v[[B - 1, B - 1]] for v in host_batch)), roster)
        w.finish()
    ref, got = tree_bytes(roots["a"]), tree_bytes(roots["b"])
    assert len(ref) == 6 * B + 3  # rgb, depth csv+png, pointcloud, label+mask; 3 logs
    assert list(got) == list(ref)
    for name in ref:
        assert got[name] == ref[name], name
    mask = np.load(Path(roots["b"]) / "labels" / "instance_mask_000000.npy")
    assert mask.dtype == np.int32 and mask.shape == (RES, RES)
    assert bool((mask == -1).all()) == bug_compatible
    label = json.loads((Path(roots["b"]) / "labels" / "label_000001.json").read_text())
    assert list(label) == list(jschema.label_dict(0, [0] * 7, {}, [], 1, 1))
    summary = json.loads((Path(roots["b"]) / "logs" / "generation_summary.json").read_text())
    assert summary["statistics"]["total_frames_attempted"] == B + 2


def test_packed_shards_equal_jax(tmp_path, host_batch):
    cfg, jcfg = _cfgs()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jpacked.save_manifest(a, jworld.make_roster(jcfg.scene), jcfg)
    packed.save_manifest(b, world.make_roster(cfg.scene), cfg)
    assert (Path(a) / "dataset_manifest.json").read_bytes() == \
        (Path(b) / "dataset_manifest.json").read_bytes()
    no_hm = host_batch._replace(heatmaps=host_batch.heatmaps[:, :0])
    for i, batch in enumerate((host_batch, no_hm)):
        jpacked.save_shard(f"{a}/shard_{i:06d}.npz", batch, None)
        packed.save_shard(f"{b}/shard_{i:06d}.npz", batch, None)
    ref, got = list(jpacked.iter_shards(a)), list(packed.iter_shards(b))
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert list(g) == list(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    assert "heatmaps" in got[0] and "heatmaps" not in got[1]
    # f16 with numpy's round-to-nearest-even.
    np.testing.assert_array_equal(got[0]["heatmaps"], host_batch.heatmaps.astype(np.float16))


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory, host_batch):
    """Three JAX-written shards of 3, 2 and 3 frames, with heatmaps."""
    root = str(tmp_path_factory.mktemp("shards"))
    _, jcfg = _cfgs()
    jpacked.save_manifest(root, jworld.make_roster(jcfg.scene), jcfg)
    for lo, rows in ((0, [0, 1, 2]), (3, [1, 2]), (5, [2, 0, 1])):
        part = FrameBatch(*(v[rows] for v in host_batch))
        jpacked.save_shard(f"{root}/shard_{lo:06d}.npz",
                           part._replace(frame_id=np.arange(lo, lo + len(rows))), None)
    return root


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, fields=["rgb", "heatmaps"], seed=3, epochs=2),
    dict(batch_size=3, fields=None, shuffle=False, epochs=1, drop_remainder=False),
    dict(batch_size=5, fields=["frame_id", "kpt_uv"], seed=0, epochs=3, drop_remainder=False),
])
def test_reader_yields_the_jax_readers_batches(jax_shards, kw):
    ref, got = jreader.ShardDataset(jax_shards), reader.ShardDataset(jax_shards)
    assert len(got) == len(ref) == 8
    assert got.fields == ref.fields and got.manifest == ref.manifest
    assert got.field_shape("rgb") == ref.field_shape("rgb") == (3, RES, RES, 3)
    rb, gb = list(ref.batches(**kw)), list(got.batches(**kw))
    assert len(gb) == len(rb) > 0
    for r, g in zip(rb, gb):
        assert list(g) == list(r)
        for k in r:
            assert g[k].dtype == r[k].dtype
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_resume_chunks_equal_jax(tmp_path):
    from constructionsceneposeestimation_tpu.io import resume as jresume
    root = str(tmp_path)
    resume.record_completed(root, [0, 1, 2, 6, 7, 12])
    ref_manifest = Path(resume.manifest_path(root)).read_bytes()
    jresume.record_completed(str(tmp_path / "j"), [0, 1, 2, 6, 7, 12])
    assert Path(jresume.manifest_path(str(tmp_path / "j"))).read_bytes() == ref_manifest
    for batch in (1, 2, 4):
        assert resume.pending_chunks(root, 15, batch) == jresume.pending_chunks(root, 15, batch)
    assert resume.pending_chunks(root, 15, 2) == [[3, 4], [5], [8, 9], [10, 11], [13, 14]]


def test_schema_label_bytes_equal_jax(tmp_path):
    args = (7, [1.5, -2.25, 3.0, 0.0, 0.1, 0.2, 0.97], schema.camera_params_dict(12.0, 25.0, 64, 48),
            [schema.object_entry(0, 4, "dumper", [1, 2, 3], [4.5, 2.2, 2.2], [0, 0, 90], "/W/d")],
            48, 64)
    schema.save_label_json(schema.label_dict(*args), str(tmp_path / "a.json"))
    jschema.save_label_json(jschema.label_dict(*args), str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def test_fastio_is_built_into_build_not_loaded_from_native(monkeypatch):
    lib = native.get_lib()
    assert lib is not None, native.route()
    assert native.route().startswith("native libfastio_")
    path = Path(lib._name).resolve()
    assert path.parent == native.BUILD_DIR and path == native.library_path()
    assert path != Path(jnative._find_lib()).resolve()

    def no_compiler(*args, **kwargs):
        raise AssertionError("fastio compiled again")

    # A second build call finds the library and runs no compiler.
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.build() == path


def test_fastio_output_equals_jax():
    """The port's build of fastio against the JAX package's library, and
    the port's fallbacks against both on values whose %.6f rounding is not
    a tie (fastio rounds ties up, printf to even: 1/128 = 0.0078125)."""
    rng = np.random.RandomState(5)
    m = rng.uniform(-300, 300, (500, 6)).astype(np.float32)
    m[0, :4] = [np.inf, -np.inf, 0.0, 1.0 / 128]
    m[1, :3] = [1.9e13, -1.85e13, 123.456]
    img = rng.randint(0, 256, (31, 45, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (77,)).astype(np.uint8)
    assert native.format_floats_6f(m, "x y z r g b") == jnative.format_floats_6f(m, "x y z r g b")
    assert native.encode_png_rgb8(img) == jnative.encode_png_rgb8(img)
    np.testing.assert_array_equal(native.jet_colormap(gray), jnative.jet_colormap(gray))
    no_ties = m[1:].copy()
    ties = np.isfinite(no_ties) & ((no_ties * 128) % 2 == 1)
    no_ties[ties] = np.nextafter(no_ties[ties], np.float32(np.inf))
    lib = native._LIB
    try:
        native._LIB = None
        fallback = (native.format_floats_6f(no_ties), native.jet_colormap(gray))
    finally:
        native._LIB = lib
    assert fallback[0] == jnative.format_floats_6f(no_ties)
    np.testing.assert_array_equal(fallback[1], jnative.jet_colormap(gray))
