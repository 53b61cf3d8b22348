"""Every cell of the manifest, wired end to end on the CPU at 64^2: set-up,
warm-up, a window of a few batches or steps, the check against the
reference, and the result line's shape; the traced run's per-layer
metrics. A test on the card runs each cell as the driver does."""

import json
import os
import subprocess
import sys

import pytest
import torch

import perfbench_tiny as tiny

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("name", tiny.cells())
def test_cell_runs_and_checks(name):
    cell = tiny.tiny(name)
    result, checks = tiny.run(cell)
    assert RESULT_KEYS <= set(result)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(checks) == set(cell.limits), "every compared number has a limit"
    assert result["correct"], checks
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", ["world2-proxy-512.iid-b512", "world2-proxy-512.train-b32",
                                  "world2-proxy-512.clips-b510",
                                  "world2-proxy-512.train-ddp4-b128"])
def test_traced_run(name):
    cell = tiny.tiny(name)
    result, checks = tiny.run(cell, trace=True)
    assert result["correct"], checks
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    # the readers that need no device activity find something on the CPU
    for m in cell.per_layer:
        if m["name"].startswith(("frames_per_s.", "sample_host_ms.")):
            assert result["metrics"][m["name"]]["value"] > 0, m["name"]
    assert {"device_ops", "idle_gaps"} == set(result["breakdown"])
    assert result["device"]["window_s"] > 0
    json.dumps(result)


def test_refuses_without_a_card():
    """The command exits non-zero and prints no result without CUDA."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(tiny.BENCH / "run.py"), "--workload",
                          tiny.cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tiny.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.cells())
def test_cell_on_the_card(name):
    """The command as the driver runs it, at the cell's own size."""
    chips = tiny.manifest.load_cell(name).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    out = subprocess.run([sys.executable, str(tiny.BENCH / "run.py"), "--workload", name,
                          "--seed", str(tiny.SEED), "--seconds", "5", "--trace", "0"],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
