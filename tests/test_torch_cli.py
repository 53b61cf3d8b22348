"""The port's CLI: ``train-eval`` on the CPU at 64^2 prints every line the
JAX command prints (``constructionsceneposeestimation_tpu/cli.py:262-331``),
in its order and format, crane rows included; ``train`` saves and resumes
checkpoints with the JAX command's messages; ``--data-dir`` is refused."""

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


def test_data_dir_is_not_accepted_yet(capsys):
    with pytest.raises(SystemExit):
        cli.main(["train", *SMALL, "--data-dir", "shards"])
    assert "--data-dir" in capsys.readouterr().err
