"""The port's CLI: ``train-eval`` on the CPU at 64^2 prints every line the
JAX command prints (``constructionsceneposeestimation_tpu/cli.py:262-331``),
in its order and format, crane rows included; ``train`` saves and resumes
checkpoints with the JAX command's messages; ``--data-dir`` trains from
packed shards and refuses what the JAX loop refuses. The two-stage
commands: ``train-crop`` (the dumper, the crane per part), ``train-detect``
(with both crop checkpoints, the miss split and the FULL rows; from shards)
and ``infer`` print the JAX commands' lines, save and resume, write the
JAX records, and refuse no flag. Clips, the hifi tier and the image-texture
tier: ``generate --sequence-len`` (both formats, resume; with
``--image-textures``), ``generate --hifi`` (with ``--image-textures``),
``infer --sequence-len --track``, ``seq-eval`` (the JAX command's text on
the same records), ``train-detect --hifi-mix --hifi-eval`` and with
``--image-textures``."""

import contextlib
import io
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from constructionsceneposeestimation_tpu_torch import cli

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--lite", "--size", "64", "--batch", "2"]


def D(n):
    """A number printed with ``n`` decimals."""
    return rf"-?\d+\.\d{{{n}}}"


# The JAX command's lines after training, as regular expressions of its
# format strings.
EVAL_LINES = [
    rf"decode-floor PCK@0\.5: {D(3)}  \(n=\d+\)",
    rf"model PCK@0\.5:        {D(3)}  mean matched err {D(2)} px",
    rf"assoc decode floor:   {D(3)}  model assoc PCK@0\.5: {D(3)} \(recall {D(3)}\)",
    rf"human PCK@0\.5 \(DARK\):  floor {D(3)}  model {D(3)} \(n=\d+, err {D(2)} px\)",
    rf"  weakest joints: \w+={D(2)} \w+={D(2)} \w+={D(2)} \w+={D(2)}",
    rf"human PCK@0\.5 \(soft-argmax\):  floor {D(3)}  model {D(3)} \(n=\d+, err {D(2)} px\)",
    rf"dumper channel scores: mean {D(3)} max {D(3)} >=0\.3: {D(2)} >=0\.15: {D(2)}",
    rf"dumper ADD \(GT kpts\):    mean {D(3)} m, ADD-0\.1d {D(3)} \(accepted \d+/\d+\)",
    rf"dumper ADD \(model kpts\): mean {D(3)} m, ADD-0\.1d {D(3)} \(accepted \d+/\d+, "
    rf"rmse {D(4)}\)",
    rf"crane ADD \(GT kpts\):  mean {D(3)} m, ADD-0\.1d {D(3)} \[base={D(2)} "
    rf"column={D(2)} boom={D(2)} telescopic={D(2)}\] \(accepted \d+/\d+\)",
    rf"crane ADD \(model kpts\):  mean {D(3)} m, ADD-0\.1d {D(3)} \[base={D(2)} "
    rf"column={D(2)} boom={D(2)} telescopic={D(2)}\] \(accepted \d+/\d+\)",
]
STEP = rf"step \d+: loss={D(5)} \({D(1)} img/s avg\)"


def _run(capsys, argv):
    cli.main(argv)
    return capsys.readouterr().out.splitlines()


def test_train_eval_prints_every_line_of_the_jax_command():
    """The command as a user types it, through ``python -m``."""
    out = subprocess.run(
        [sys.executable, "-m", "constructionsceneposeestimation_tpu_torch.cli", "train-eval",
         *SMALL, "--steps", "2", "--eval-frames", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert re.fullmatch(STEP, lines[0]) and lines[0].startswith("step 2:")
    assert len(lines) == 1 + len(EVAL_LINES)
    for line, pattern in zip(lines[1:], EVAL_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)


def test_train_saves_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    lines = _run(capsys, ["train", *SMALL, "--steps", "2", "--inner", "1", "--ckpt-dir", ck,
                          "--save-every", "1"])
    assert [ln.split(":")[0] for ln in lines if ln.startswith("step")] == ["step 1", "step 2"]
    assert all(re.fullmatch(STEP, ln) for ln in lines if ln.startswith("step"))
    assert "checkpointed step 1" in lines and "checkpointed step 2" in lines
    assert lines[-1] == f"saved checkpoint at step 2 -> {ck}"
    lines = _run(capsys, ["train", *SMALL, "--steps", "3", "--inner", "1", "--ckpt-dir", ck])
    assert lines[0] == "restored checkpoint at step 2"
    assert lines[1].startswith("step 3:") and lines[-1] == f"saved checkpoint at step 3 -> {ck}"
    # Nothing left to train: restore, no step, no save.
    assert _run(capsys, ["train", *SMALL, "--steps", "3", "--ckpt-dir", ck]) == [
        "restored checkpoint at step 3"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Packed shards from the port's ``generate`` at 64^2: 6 frames with
    heatmaps, and 3 frames without."""
    root = tmp_path_factory.mktemp("shards")
    base = ["generate", "--device", "cpu", "--size", "64", "--batch", "3", "--format", "packed"]
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(base + ["--frames", "6", "--heatmaps", "--out", str(root / "hm")])
        cli.main(base + ["--frames", "3", "--out", str(root / "no_hm")])
    return {"hm": str(root / "hm"), "no_hm": str(root / "no_hm")}


def test_data_dir_is_not_accepted_yet(shards, capsys):
    """The name is kept from when the port had no ``--data-dir``. The flag
    is now accepted, and the offline loop refuses what the JAX loop
    refuses with the JAX loop's words: ``--camera-mix`` with ``--data-dir``,
    shards without heatmaps, a ``--size`` that is not the shards', fewer
    frames than ``--batch`` and a roster that is not the shards'."""
    from constructionsceneposeestimation_tpu import cli as jcli
    from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
    from constructionsceneposeestimation_tpu.scene import world as jworld
    from constructionsceneposeestimation_tpu_torch.config import SceneConfig
    from constructionsceneposeestimation_tpu_torch.scene import world

    with pytest.raises(SystemExit, match="--camera-mix configures the on-device generator"):
        cli.main(["train", *SMALL, "--data-dir", shards["hm"], "--camera-mix", "0.3"])
    cases = [
        (["--camera-mix", "0.3"], "hm", False, "--camera-mix configures"),
        ([], "no_hm", False, "lack fields ['heatmaps']"),
        (["--size", "32"], "hm", False, "dataset frames are 64x64 but --size is 32"),
        (["--batch", "8"], "hm", False, "dataset has 6 frames < --batch 8"),
        ([], "hm", True, "dataset instance layout (40 instances) does not match"),
    ]
    for extra, data, two_dumpers, words in cases:
        args = cli.build_parser().parse_args(["train", *SMALL, "--data-dir", shards[data],
                                              *extra])
        roster = jroster = None
        if two_dumpers:
            roster = world.make_roster(SceneConfig(n_dumpers=2))
            jroster = jworld.make_roster(JSceneConfig(n_dumpers=2))
        with pytest.raises(SystemExit) as got:
            cli._offline_train(args, None, None, 0, ("rgb", "heatmaps"), None, roster)
        with pytest.raises(SystemExit) as ref:
            jcli._offline_train(args, None, None, 0, ("rgb", "heatmaps"), None, jroster)
        assert words in str(got.value)
        assert str(got.value) == str(ref.value).replace("`cspe-tpu generate", "`generate")


def test_train_from_data_dir(shards, tmp_path, capsys, monkeypatch):
    """``train --data-dir`` trains from the shards, generates nothing,
    prints the JAX loop's line, checkpoints, and resumes from the shards."""
    from constructionsceneposeestimation_tpu_torch.parallel import pipeline

    def no_render(*a, **k):
        raise AssertionError("--data-dir training generated a batch")

    monkeypatch.setattr(pipeline.Pipeline, "render", no_render)
    ck = str(tmp_path / "ck")
    argv = ["train", *SMALL, "--data-dir", shards["hm"], "--ckpt-dir", ck]
    lines = _run(capsys, argv + ["--steps", "4"])
    assert re.fullmatch(rf"step 4: loss={D(5)} \({D(1)} img/s avg, offline shards\)", lines[0])
    assert lines[1:] == [f"saved checkpoint at step 4 -> {ck}"]
    assert math.isfinite(float(lines[0].split("loss=")[1].split()[0]))
    lines = _run(capsys, argv + ["--steps", "6"])
    assert lines[0] == "restored checkpoint at step 4"
    assert lines[1].startswith("step 6: loss=") and lines[1].endswith("offline shards)")
    assert lines[2] == f"saved checkpoint at step 6 -> {ck}"


# The two-stage commands: the JAX command's lines after training
# (constructionsceneposeestimation_tpu/cli.py:379-421, :493-590, :789).
STEP_VIS = rf"step \d+: loss={D(5)} vis=\d+/2 \({D(1)} img/s avg\)"
CRANE_PARTS = rf"\[base={D(2)} column={D(2)} boom={D(2)} telescopic={D(2)}\]"
CROP_LINES = {
    "dumper": [rf"dumper crop-stage 6DoF: ADD mean {D(3)} m, ADD-0\.1d {D(3)} \(accepted \d+/\d+, "
               rf"detectable \d+/2, rmse {D(4)}\)"],
    "crane": [rf"crane crop-stage 6DoF: ADD mean {D(3)} m, ADD-0\.1d {D(3)} {CRANE_PARTS} "
              rf"\(accepted \d+/\d+, detectable \d+/2\)",
              rf"  per-part err split \(t/rot\): \[base={D(2)}m/{D(1)}deg column={D(2)}m/"
              rf"{D(1)}deg boom={D(2)}m/{D(1)}deg telescopic={D(2)}m/{D(1)}deg\]"],
}
PR = rf"{D(2)}/{D(2)}"
DETECT_LINES = [
    rf"detector P/R @IoU0\.5: {D(3)}/{D(3)}  \[dumper={PR} crane={PR} human={PR} "
    rf"trafficcone={PR}\]",
    rf"  crane parts P/R: \[base={PR} column={PR} boom={PR} telescopic={PR}\]  "
    rf"mAP@0\.5 {D(3)}",
]
MISS = rf"  miss split \w+: score {D(2)} cls {D(2)} loc {D(2)}  \(recall {D(2)}\)"
FULL_LINES = [
    rf"FULL two-stage dumper 6DoF \(detector boxes\): ADD mean {D(3)} m, ADD-0\.1d {D(3)} "
    rf"\(accepted \d+/\d+\)",
    rf"FULL two-stage multi-dumper 6DoF \(detector boxes, 2 instances\): ADD mean {D(3)} m, "
    rf"ADD-0\.1d {D(3)} \(accepted \d+/\d+ detectable\)",
    rf"FULL two-stage crane 6DoF \(detector part boxes\): ADD mean {D(3)} m, ADD-0\.1d {D(3)} "
    rf"{CRANE_PARTS} \(accepted \d+/\d+\)",
]
# Full-width networks (`infer` restores the full-width crop nets, as the JAX
# command does), 2 frames of 64^2 a step, 32^2 crops.
TWO = ["--device", "cpu", "--size", "64", "--batch", "2", "--crop", "32", "--eval-frames", "2"]
CRANE = ["--cls", "crane", "--per-part", "--stride", "2"]


@pytest.fixture(scope="module")
def two_stage(tmp_path_factory):
    """train-crop (dumper, then the crane per part), train-detect with both
    crop checkpoints and infer, run once: their checkpoint dirs and output."""
    root = tmp_path_factory.mktemp("two_stage")
    ck = {k: str(root / k) for k in ("dumper", "crane", "det")}
    out = {}

    def run(name, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        out[name] = buf.getvalue().splitlines()

    run("dumper", ["train-crop", *TWO, "--steps", "2", "--inner", "1", "--save-every", "1",
                   "--ckpt-dir", ck["dumper"]])
    run("crane", ["train-crop", *TWO, *CRANE, "--steps", "2", "--inner", "2",
                  "--ckpt-dir", ck["crane"]])
    run("det", ["train-detect", *TWO, "--steps", "2", "--inner", "2", "--det-stride", "2",
                "--n-dumpers", "2", "--n-humans", "3", "--det-analysis", "--crop-ckpt",
                ck["dumper"], "--crane-crop-ckpt", ck["crane"], "--crane-stride", "2",
                "--crane-crop", "32", "--ckpt-dir", ck["det"]])
    poses = str(root / "poses.jsonl")
    run("infer", ["infer", "--device", "cpu", "--size", "64", "--frames", "3", "--batch", "2",
                  "--crop", "32", "--det-ckpt", ck["det"], "--det-stride", "2", "--crop-ckpt",
                  ck["dumper"], "--crane-crop-ckpt", ck["crane"], "--crane-stride", "2",
                  "--crane-crop", "32", "--det-threshold", "0.05", "--track", "--out", poses])
    return ck, out, poses


def test_train_crop_prints_every_line_of_the_jax_command(two_stage):
    ck, out, _ = two_stage
    lines = out["dumper"]
    assert [ln.split(":")[0] for ln in lines if ln.startswith("step")] == ["step 1", "step 2"]
    assert all(re.fullmatch(STEP_VIS, ln) for ln in lines if ln.startswith("step"))
    assert "checkpointed step 1" in lines and "checkpointed step 2" in lines
    assert lines[-2] == f"saved checkpoint at step 2 -> {ck['dumper']}"
    assert re.fullmatch(CROP_LINES["dumper"][0], lines[-1]), lines[-1]
    lines = out["crane"]
    assert re.fullmatch(STEP_VIS, lines[0])
    assert lines[0].startswith("step 2:") and len(lines) == 4
    assert lines[1] == f"saved checkpoint at step 2 -> {ck['crane']}"
    for line, pattern in zip(lines[2:], CROP_LINES["crane"]):
        assert re.fullmatch(pattern, line), (line, pattern)


def test_train_crop_resumes(two_stage, tmp_path, capsys):
    """A copy of the dumper's checkpoint dir: one more step, then nothing
    left to train (restore, no step, no save, the evaluation)."""
    import shutil
    ck = str(tmp_path / "ck")
    shutil.copytree(two_stage[0]["dumper"], ck)
    lines = _run(capsys, ["train-crop", *TWO, "--steps", "3", "--inner", "1", "--ckpt-dir", ck])
    assert lines[0] == "restored checkpoint at step 2"
    assert re.fullmatch(STEP_VIS, lines[1]) and lines[1].startswith("step 3:")
    assert lines[2] == f"saved checkpoint at step 3 -> {ck}"
    lines = _run(capsys, ["train-crop", *TWO, "--steps", "3", "--ckpt-dir", ck])
    assert lines[0] == "restored checkpoint at step 3" and len(lines) == 2
    assert re.fullmatch(CROP_LINES["dumper"][0], lines[1])


def test_train_detect_prints_every_line_of_the_jax_command(two_stage):
    ck, out, _ = two_stage
    lines = out["det"]
    assert re.fullmatch(rf"step 2: loss={D(5)} \({D(1)} img/s avg\)", lines[0]), lines[0]
    assert lines[1] == f"saved checkpoint at step 2 -> {ck['det']}"
    assert re.fullmatch(DETECT_LINES[0], lines[2]) and re.fullmatch(DETECT_LINES[1], lines[3])
    misses = [ln for ln in lines if ln.startswith("  miss split")]
    assert misses and all(re.fullmatch(MISS, ln) for ln in misses)
    assert lines[4:4 + len(misses)] == misses
    rest = lines[4 + len(misses):]
    assert len(rest) == len(FULL_LINES)
    for line, pattern in zip(rest, FULL_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)


def test_infer_writes_the_jax_records(two_stage):
    """3 frames in batches of 2: the padded last batch writes frame 2 only;
    key order as the JAX command's; --track adds track ids."""
    _, out, poses = two_stage
    records = [json.loads(ln) for ln in open(poses)]
    n_det = sum(len(r["detections"]) for r in records)
    assert out["infer"] == [f"wrote 3 frame records ({n_det} detections) -> {poses}"]
    assert [r["frame_id"] for r in records] == [0, 1, 2]
    assert all(list(r) == ["frame_id", "camera_pose7", "detections"] for r in records)
    assert n_det > 0 and all(len(r["camera_pose7"]) == 7 for r in records)
    for d in (d for r in records for d in r["detections"]):
        assert "track_id" in d
        head = ["class", "pose_accepted", "reproj_rmse_px", "parts"] if d["class"] == "crane" \
            else ["class", "score", "bbox2d"]
        assert list(d)[:len(head)] == head


def test_train_detect_from_data_dir(shards, tmp_path, capsys):
    """``train-detect --data-dir`` (lite, stride 4) trains from the shards
    with the JAX loop's line and checkpoints, then evaluates."""
    ck = str(tmp_path / "ck")
    lines = _run(capsys, ["train-detect", *TWO, "--lite", "--steps", "2", "--data-dir",
                          shards["hm"], "--ckpt-dir", ck])
    assert re.fullmatch(rf"step 2: loss={D(5)} \({D(1)} img/s avg, offline shards\)", lines[0])
    assert lines[1] == f"saved checkpoint at step 2 -> {ck}"
    assert re.fullmatch(DETECT_LINES[0], lines[2]) and len(lines) == 4


@pytest.mark.parametrize("argv,flag", [
    (["train-detect", "--hifi-mix", "4"], "--hifi-mix"),
    (["train-detect", "--hifi-eval"], "--hifi-eval"),
    (["train-detect", "--image-textures"], "--image-textures"),
    (["infer", "--det-ckpt", "d", "--crop-ckpt", "c", "--sequence-len", "30"], "--sequence-len"),
    (["infer", "--det-ckpt", "d", "--crop-ckpt", "c", "--hifi"], "--hifi"),
])
def test_two_stage_refuses_unported_flags(argv, flag, tmp_path, monkeypatch, capsys):
    """No flag is refused any more: each parses, and the commands run on
    the card unless ``--device cpu`` (the commands that take the hifi and
    clip flags are driven below). ``train-detect --image-textures`` runs
    with ``--hifi-mix 2 --hifi-eval``, 2 steps of 2 frames at 64^2: the
    image textures apply to the hifi batch (step 0) and the evaluation
    frames only, the proxy batch (step 1) stays untextured, as in the JAX
    command, and it prints the JAX command's lines."""
    from constructionsceneposeestimation_tpu_torch.render import textures

    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    assert getattr(args, flag[2:].replace("-", "_"))
    for cmd in (["train-crop"], ["train-detect"], ["infer", "--det-ckpt", "d", "--crop-ckpt", "c"]):
        assert cli.build_parser().parse_args(cmd).device == "cuda"
    if flag != "--image-textures":
        return
    textured = []
    apply = textures.apply_image_textures
    monkeypatch.setattr(textures, "apply_image_textures",
                        lambda alb, *a: textured.append(alb[0].shape[0]) or apply(alb, *a))
    ck = str(tmp_path / "ck")
    lines = _run(capsys, argv + TWO + ["--lite", "--steps", "2", "--inner", "1", "--hifi-mix",
                                       "2", "--hifi-eval", "--ckpt-dir", ck])
    assert textured == [2, 2]
    assert all(re.fullmatch(STEP, ln) for ln in lines[:2])
    assert lines[2] == f"saved checkpoint at step 2 -> {ck}"
    assert lines[3] == "eval frames: hifi CAD-mesh renders (proxy-trained models)"
    assert re.fullmatch(DETECT_LINES[0], lines[4]) and re.fullmatch(DETECT_LINES[1], lines[5])


# Sequence mode and the hifi tier through the commands: clips of 3 at 64^2.
SEQ = ["--device", "cpu", "--size", "64", "--sequence-len", "3"]


def _shards_equal(out, chunks, gen):
    """Every shard under ``out`` holds ``gen`` on its chunk's padded ids."""
    import numpy as np
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import HostCopy
    for chunk in chunks:
        with torch.no_grad():
            want = HostCopy(gen(0, chunk)).wait()
        with np.load(f"{out}/shard_{chunk[0]:06d}.npz") as z:
            for k in z.files:
                v = getattr(want, k)
                np.testing.assert_array_equal(z[k], v.astype(np.float16) if k == "heatmaps"
                                              else v, err_msg=k)


def test_generate_sequence_both_formats_and_resume(tmp_path, capsys):
    """``generate --sequence-len 3``, 5 frames in batches of 2 (chunks [0, 1],
    [2, 3] straddling two clips, [4] padded): the shards hold
    ``make_sequence_fn`` on the same padded ids; with chunk [2, 3] dropped
    from the manifest only it is regenerated, bit-equal. The reference tree
    is the JAX writer's on the same batches, byte for byte."""
    import json as json_mod
    from pathlib import Path

    from constructionsceneposeestimation_tpu.config import Config as JConfig
    from constructionsceneposeestimation_tpu.config import PipelineConfig as JPipelineConfig
    from constructionsceneposeestimation_tpu.io import dataset_writer as jdw
    from constructionsceneposeestimation_tpu.scene import world as jworld
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.io import resume
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import HostCopy, Pipeline

    chunks = [[0, 1], [2, 3], [4, 4]]
    base = ["generate", *SEQ, "--frames", "5", "--batch", "2"]
    pc = dict(render_width=64, render_height=64, batch_size=2, max_iterations=5, seed=0)
    gen = Pipeline(Config(pipeline=PipelineConfig(**pc)), device="cpu").make_sequence_fn(3)
    out = str(tmp_path / "packed")
    argv = base + ["--format", "packed", "--heatmaps", "--out", out]
    lines = _run(capsys, argv)
    assert lines[0] == "generating 5/5 frames (resume skipped 0, format=packed)"
    _shards_equal(out, chunks, gen)
    Path(f"{out}/shard_000002.npz").unlink()
    Path(resume.manifest_path(out)).write_text(
        json_mod.dumps({"completed_ranges": [[0, 2], [4, 5]]}))
    lines = _run(capsys, argv)
    assert lines[0] == "generating 2/5 frames (resume skipped 3, format=packed)"
    _shards_equal(out, chunks[1:2], gen)
    assert resume.load_manifest(out) == set(range(5))

    ref_out, jax_out = str(tmp_path / "a" / "ds"), str(tmp_path / "b" / "ds")
    lines = _run(capsys, base + ["--format", "reference", "--out", ref_out])
    jcfg = JConfig(pipeline=JPipelineConfig(**pc))
    writer = jdw.DatasetWriter(jcfg, root=jax_out)
    nohm = Pipeline(Config(pipeline=PipelineConfig(**pc)), device="cpu").make_sequence_fn(
        3, include_heatmaps=False)
    for chunk in chunks:
        with torch.no_grad():
            writer.write_batch(HostCopy(nohm(0, chunk)).wait(), jworld.make_roster(jcfg.scene))
    assert "\n".join(lines[1:]) == writer.finish()
    files = lambda r: {str(p.relative_to(r)): p.read_bytes() for p in sorted(Path(r).rglob("*"))
                       if p.is_file()}
    got, want = files(ref_out), files(jax_out)
    assert list(got) == list(want) and len(want) == 6 * 5 + 3
    assert all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("textured", [False, True])
def test_generate_hifi_shards_equal_direct(tmp_path, capsys, textured):
    """``generate --hifi`` (and ``--hifi --image-textures``): the shard holds
    direct hifi generate on the same ids."""
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

    out = str(tmp_path / "hifi")
    lines = _run(capsys, ["generate", "--device", "cpu", "--size", "64", "--frames", "2",
                          "--batch", "2", "--hifi", "--format", "packed", "--out", out]
                 + ["--image-textures"] * textured)
    assert lines[0] == "generating 2/2 frames (resume skipped 0, format=packed)"
    cfg = Config(pipeline=PipelineConfig(render_width=64, render_height=64, batch_size=2,
                                         max_iterations=2))
    _shards_equal(out, [[0, 1]], Pipeline(cfg, device="cpu", hifi_mesh=True,
                                          image_textures=textured).make_generate_fn(
        include_heatmaps=False))


def test_generate_sequence_image_textures_shards_equal_direct(tmp_path, capsys):
    """``generate --sequence-len 3 --image-textures``, 4 frames in batches
    of 2: the shards hold textured ``make_sequence_fn`` on the same ids."""
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

    out = str(tmp_path / "clips")
    lines = _run(capsys, ["generate", *SEQ, "--frames", "4", "--batch", "2", "--image-textures",
                          "--format", "packed", "--heatmaps", "--out", out])
    assert lines[0] == "generating 4/4 frames (resume skipped 0, format=packed)"
    cfg = Config(pipeline=PipelineConfig(render_width=64, render_height=64, batch_size=2,
                                         max_iterations=4))
    _shards_equal(out, [[0, 1], [2, 3]], Pipeline(cfg, device="cpu", image_textures=True)
                  .make_sequence_fn(3))


def test_infer_clips_and_seq_eval(two_stage, tmp_path, monkeypatch, capsys):
    """``infer --sequence-len 2 --track`` on 5 frames in batches of 2: the
    tracker starts afresh at frames 0, 2 and 4 (and when it is built); the
    records are the clips' frames. ``seq-eval`` on those records prints the
    JAX ``cmd_seq_eval``'s lines, text for text."""
    from constructionsceneposeestimation_tpu import cli as jcli
    from constructionsceneposeestimation_tpu_torch.eval import tracking

    ck, _, _ = two_stage
    seen, resets = [], []
    update, reset = tracking.Tracker.update, tracking.Tracker.reset
    monkeypatch.setattr(tracking.Tracker, "update",
                        lambda self, d, p: seen.append(p) or update(self, d, p))
    monkeypatch.setattr(tracking.Tracker, "reset",
                        lambda self: resets.append(len(seen)) or reset(self))
    poses = str(tmp_path / "clips.jsonl")
    lines = _run(capsys, ["infer", *SEQ[:4], "--sequence-len", "2", "--frames", "5", "--batch",
                          "2", "--crop", "32", "--det-ckpt", ck["det"], "--det-stride", "2",
                          "--crop-ckpt", ck["dumper"], "--crane-crop-ckpt", ck["crane"],
                          "--crane-stride", "2", "--crane-crop", "32", "--det-threshold",
                          "0.05", "--track", "--out", poses])
    records = [json.loads(ln) for ln in open(poses)]
    assert [r["frame_id"] for r in records] == list(range(5)) and len(seen) == 5
    assert resets == [0, 0, 2, 4]
    n_det = sum(len(r["detections"]) for r in records)
    assert lines == [f"wrote 5 frame records ({n_det} detections) -> {poses}"] and n_det > 0
    for argv in (["--sequence-len", "2", "--fps", "10"], ["--sequence-len", "3"]):
        mine = _run(capsys, ["seq-eval", "--poses", poses, *argv])
        jcli.cmd_seq_eval(cli.build_parser().parse_args(["seq-eval", "--poses", poses, *argv]))
        assert mine == capsys.readouterr().out.splitlines()
        assert mine[0].startswith("sequence eval (") and len(mine) >= 5


def test_train_detect_hifi_mix_and_eval(tmp_path, monkeypatch, capsys):
    """``train-detect --hifi-mix 2 --hifi-eval``, 3 steps of 2 frames at 64^2
    (lite): steps 0 and 2 and the evaluation batch render through the hifi
    sweep, step 1 through the proxies; the JAX command's lines, with its
    hifi-eval line before the evaluation's."""
    from constructionsceneposeestimation_tpu_torch.render import meshcast

    hifi_calls = []
    call = meshcast.HifiSweeper.__call__
    monkeypatch.setattr(meshcast.HifiSweeper, "__call__",
                        lambda self, w, c, M: hifi_calls.append(c.shape[0]) or call(self, w, c, M))
    ck = str(tmp_path / "ck")
    lines = _run(capsys, ["train-detect", *TWO, "--lite", "--steps", "3", "--inner", "1",
                          "--hifi-mix", "2", "--hifi-eval", "--ckpt-dir", ck])
    assert hifi_calls == [2, 2, 2]
    assert [ln.split(":")[0] for ln in lines[:3]] == ["step 1", "step 2", "step 3"]
    assert all(re.fullmatch(rf"step \d+: loss={D(5)} \({D(1)} img/s avg\)", ln)
               for ln in lines[:3])
    assert lines[3] == f"saved checkpoint at step 3 -> {ck}"
    assert lines[4] == "eval frames: hifi CAD-mesh renders (proxy-trained models)"
    assert re.fullmatch(DETECT_LINES[0], lines[5]) and re.fullmatch(DETECT_LINES[1], lines[6])
