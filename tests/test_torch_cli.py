"""The port's CLI: ``train-eval`` on the CPU at 64^2 prints every line the
JAX command prints (``constructionsceneposeestimation_tpu/cli.py:262-331``),
in its order and format, crane rows included; ``train`` saves and resumes
checkpoints with the JAX command's messages; ``--data-dir`` trains from
packed shards and refuses what the JAX loop refuses."""

import contextlib
import io
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
