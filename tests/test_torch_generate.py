"""The port's ``generate`` command on the CPU against direct generate calls
and the JAX package's writers.

``cli.main(["generate", "--device", "cpu", ...])`` at 64^2, 5 frames in
batches of 2: chunks [0, 1], [2, 3] and [4] padded to [4, 4]. Its shards
must hold exactly the arrays of ``Pipeline.make_generate_fn()`` called on
the same padded ids, and its reference tree must be byte for byte what the
JAX ``DatasetWriter`` writes from those same batches. Resume skips what the
manifest records and regenerates only what it lacks."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.config import PipelineConfig as JPipelineConfig
from constructionsceneposeestimation_tpu.io import dataset_writer as jdw
from constructionsceneposeestimation_tpu.io import packed as jpacked
from constructionsceneposeestimation_tpu.io import resume as jresume
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import cli
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
from constructionsceneposeestimation_tpu_torch.io import packed, resume
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import HostCopy, Pipeline

torch.set_num_threads(2)
RES, FRAMES, B = 64, 5, 2
CHUNKS = [[0, 1], [2, 3], [4, 4]]
ARGS = ["generate", "--device", "cpu", "--size", str(RES), "--frames", str(FRAMES),
        "--batch", str(B), "--seed", "3"]
PC = dict(render_width=RES, render_height=RES, batch_size=B, max_iterations=FRAMES, seed=3)


def _run(capsys, argv):
    cli.main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.fixture(scope="module")
def direct():
    """Each padded chunk through ``make_generate_fn`` directly, as numpy."""
    gen = Pipeline(Config(pipeline=PipelineConfig(**PC)), device="cpu").make_generate_fn()
    with torch.no_grad():
        return [HostCopy(gen(3, ids)).wait() for ids in CHUNKS]


def tree_bytes(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _shard_equals(path, batch):
    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    want = {f: getattr(batch, f) for f in ("frame_id", "rgb", "depth", "instance",
                                           "camera_pose7", "inst_visible", "inst_pixel_count",
                                           "bbox2d", "center", "size", "euler_deg", "kpt_uv",
                                           "kpt_visible", "pointcloud_count")}
    want["heatmaps"] = batch.heatmaps.astype(np.float16)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_packed_shards_equal_direct_generate_and_resume(tmp_path, capsys, direct):
    out = str(tmp_path / "ds")
    argv = ARGS + ["--format", "packed", "--heatmaps", "--out", out]
    lines = _run(capsys, argv)
    assert lines[0] == f"generating {FRAMES}/{FRAMES} frames (resume skipped 0, format=packed)"
    assert lines[1].startswith(f"done: {FRAMES} frames in ") and lines[1].endswith(
        " fps incl. writes)")
    shards = [f"shard_{c[0]:06d}.npz" for c in CHUNKS]
    assert sorted(p for p in os.listdir(out) if p.endswith(".npz")) == shards
    for name, batch in zip(shards, direct):
        _shard_equals(os.path.join(out, name), batch)
    # The padded last chunk is stored whole: two rows of frame 4.
    with np.load(os.path.join(out, shards[-1])) as z:
        np.testing.assert_array_equal(z["frame_id"], [4, 4])
    assert resume.load_manifest(out) == set(range(FRAMES))

    # The same arrays as the JAX package's save_shard of the same batches,
    # and the same manifests.
    ref = str(tmp_path / "jax")
    jcfg = JConfig(pipeline=JPipelineConfig(**PC))
    jpacked.save_manifest(ref, jworld.make_roster(jcfg.scene), jcfg)
    for chunk, batch in zip(CHUNKS, direct):
        jpacked.save_shard(f"{ref}/shard_{chunk[0]:06d}.npz", batch, None)
        jresume.record_completed(ref, sorted(set(chunk)))
    for name in ("dataset_manifest.json", "logs/manifest.json"):
        assert Path(out, name).read_bytes() == Path(ref, name).read_bytes(), name
    for r, g in zip(jpacked.iter_shards(ref), packed.iter_shards(out)):
        assert list(g) == list(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)

    # Nothing pending: no shard is touched.
    stamps = {p: os.stat(os.path.join(out, p)).st_mtime_ns for p in shards}
    lines = _run(capsys, argv)
    assert lines[0] == f"generating 0/{FRAMES} frames (resume skipped {FRAMES}, format=packed)"
    assert lines[1].startswith("done: 0 frames in ")
    assert {p: os.stat(os.path.join(out, p)).st_mtime_ns for p in shards} == stamps

    # Frames 2-3 dropped from the manifest: only their chunk is regenerated.
    os.remove(os.path.join(out, shards[1]))
    data = json.loads(Path(resume.manifest_path(out)).read_text())
    assert data == {"completed_ranges": [[0, FRAMES]]}
    Path(resume.manifest_path(out)).write_text(
        json.dumps({"completed_ranges": [[0, 2], [4, FRAMES]]}))
    lines = _run(capsys, argv)
    assert lines[0] == f"generating 2/{FRAMES} frames (resume skipped 3, format=packed)"
    assert {p: os.stat(os.path.join(out, p)).st_mtime_ns for p in (shards[0], shards[2])} == {
        p: stamps[p] for p in (shards[0], shards[2])}
    _shard_equals(os.path.join(out, shards[1]), direct[1])
    assert resume.load_manifest(out) == set(range(FRAMES))


def test_reference_tree_equals_jax_writer(tmp_path, capsys, direct):
    """The CLI's tree against the JAX ``DatasetWriter`` fed the same padded
    batches: the repeats of frame 4 are written and logged again by both."""
    out = str(tmp_path / "a" / "ds")
    lines = _run(capsys, ARGS + ["--format", "reference", "--out", out])
    assert lines[0] == f"generating {FRAMES}/{FRAMES} frames (resume skipped 0, format=reference)"
    assert "=== 数据生成汇总报告 ===" in lines
    jcfg = JConfig(pipeline=JPipelineConfig(**PC))
    ref = str(tmp_path / "b" / "ds")
    w = jdw.DatasetWriter(jcfg, root=ref)
    for batch in direct:
        w.write_batch(batch, jworld.make_roster(jcfg.scene))
    report = w.finish()
    assert "\n".join(lines[1:]) == report
    got, want = tree_bytes(out), tree_bytes(ref)
    assert list(got) == list(want) and len(want) == 6 * FRAMES + 3
    for name in want:
        assert got[name] == want[name], name
    summary = json.loads(Path(out, "logs", "generation_summary.json").read_text())
    assert summary["statistics"]["total_frames_attempted"] == 6  # frame 4 twice


@pytest.mark.parametrize("flag", [["--sequence-len", "4"], ["--hifi"], ["--image-textures"]])
def test_unported_generate_flags_are_refused(tmp_path, flag, capsys):
    """No flag is refused any more: clips, the hifi tier and the
    image-texture tier each write their reference tree (2 frames here;
    tests/test_torch_cli.py and the test below hold them to direct
    generate)."""
    argv = ARGS + ["--out", str(tmp_path / "ds"), *flag]
    lines = _run(capsys, argv + ["--frames", "2"])
    assert lines[0] == "generating 2/2 frames (resume skipped 0, format=reference)"
    summary = json.loads(Path(tmp_path, "ds", "logs", "generation_summary.json").read_text())
    assert [f["frame_id"] for f in summary["frame_logs"]] == [0, 1]
    assert all(Path(tmp_path, "ds", "labels", f"label_{i:06d}.json").is_file() for i in (0, 1))


def test_image_textures_packed_equals_direct_textured_generate(tmp_path, capsys):
    """``generate --image-textures --format packed --heatmaps``: every shard
    holds textured ``make_generate_fn`` on its padded ids; the labels are
    the untextured generate's, the RGB is not."""
    out = str(tmp_path / "ds")
    lines = _run(capsys, ARGS + ["--format", "packed", "--heatmaps", "--image-textures",
                                 "--out", out])
    assert lines[0] == f"generating {FRAMES}/{FRAMES} frames (resume skipped 0, format=packed)"
    assert lines[1].startswith(f"done: {FRAMES} frames in ")
    cfg = Config(pipeline=PipelineConfig(**PC))
    tex = Pipeline(cfg, device="cpu", image_textures=True).make_generate_fn()
    plain = Pipeline(cfg, device="cpu").make_generate_fn()
    for ids in CHUNKS:
        with torch.no_grad():
            want = HostCopy(tex(3, ids)).wait()
        _shard_equals(os.path.join(out, f"shard_{ids[0]:06d}.npz"), want)
    with torch.no_grad():
        base = HostCopy(plain(3, CHUNKS[-1])).wait()
    for f in ("depth", "instance", "bbox2d", "kpt_uv", "kpt_visible", "heatmaps"):
        np.testing.assert_array_equal(getattr(want, f), getattr(base, f), err_msg=f)
    assert not np.array_equal(want.rgb, base.rgb)


def test_generate_on_a_missing_card_raises(tmp_path):
    """``--device cuda`` (the default) on a host without a card fails; it
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["generate", "--size", "64", "--frames", "2", "--batch", "2",
                  "--format", "packed", "--out", str(tmp_path / "ds")])
    assert not list((tmp_path / "ds").glob("shard_*.npz"))
