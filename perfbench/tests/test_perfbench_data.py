"""The harness takes a new configuration, traffic mix, per-layer metric,
model and cell as data: in a copy of the benchmark, files and manifest
entries are added, no file that is there is edited, and the harness finds
and runs them."""

import json
import os
import shutil
import subprocess
import sys

import perfbench_tiny as tiny

RUN = """
import json, sys, torch
from harness import cli, manifest, session
cell = manifest.load_cell("world2-proxy-64.iid-b4")
result, checks = cli.run_cell(cell, 2 ** 33 + 5, 0.5, True, torch.device("cpu"),
                              session.SetupClock())
print(json.dumps({"result": result, "checks": checks}))
"""


def test_new_cell_from_data_alone(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "perfbench"
    shutil.copytree(tiny.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    conf = json.loads((bench / "configs" / "world2-proxy-512.json").read_text())
    conf.update(name="world2-proxy-64", resolution=[64, 64])
    (bench / "configs" / "world2-proxy-64.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "mixes" / "iid-b512.json").read_text())
    mix.update(batch=4, check_frames=2, warmup_batches=1, profile_batches=2)
    (bench / "mixes" / "iid-b4.json").write_text(json.dumps(mix))
    (bench / "metrics" / "batches_profiled.gen.py").write_text(
        "def read(trace):\n    return float(trace.batches)\n")
    shutil.copy(bench / "limits" / "world2-proxy-512.iid-b512.json",
                bench / "limits" / "world2-proxy-64.iid-b4.json")
    man = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "world2-proxy-64", "source": man["configs"][0]["source"],
                           "file": "perfbench/configs/world2-proxy-64.json",
                           "reduced": ["resolution"], "why": "a test's small configuration"})
    man["workloads"].append({"name": "world2-proxy-64.iid-b4", "config": "world2-proxy-64",
                             "traffic": "iid-b4", "chips": 1, "why": "a test's small cell"})
    for m in man["end_to_end"]:
        if "workloads" in m and "world2-proxy-512.iid-b512" in m["workloads"]:
            m["workloads"].append("world2-proxy-64.iid-b4")
    man["per_layer"].append({"name": "batches_profiled.gen", "unit": "count",
                             "better": "higher", "source": "program_counter",
                             "layer": "generate entry and host issue", "moves": "frames_per_s",
                             "workloads": ["world2-proxy-64.iid-b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(bench), str(root), str(tiny.ROOT)]))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["result"]["correct"], res["checks"]
    assert res["result"]["metrics"]["batches_profiled.gen"]["value"] == 2.0
    after = {p: p.read_bytes() for p in before}
    assert after == before, "a file of the benchmark was edited"


TOY = '''"""A toy backbone for a test: a strided convolution, BatchNorm, a linear
layer over the channels and a 1x1 head, at stride 4."""

import torch
from torch import nn

HEAD = ("head",)


class TinyNet(nn.Module):
    output_stride = 4

    def __init__(self, num_channels, features):
        super().__init__()
        self.stem = nn.Conv2d(3, features, 3, stride=4, padding=1, bias=False)
        self.norm = nn.BatchNorm2d(features)
        self.mix = nn.Linear(features, features)
        self.head = nn.Conv2d(features, num_channels, 1)

    def forward(self, x):
        x = torch.relu(self.norm(self.stem(x)))
        x = self.mix(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return self.head(torch.relu(x))


def port(model_cfg, num_channels, device):
    return TinyNet(num_channels, model_cfg["features"]).to(device)


def reference(model_cfg, num_channels, device):
    return TinyNet(num_channels, model_cfg["features"]).to(device)
'''

RUN_TOY = """
import json
import perfbench_tiny as tiny
result, checks = tiny.run(tiny.tiny("world2-tinynet-64.train-b2"))
print(json.dumps({"result": result, "checks": checks}))
"""


def test_new_backbone_from_data_alone(tmp_path):
    """A model is a file: a toy backbone with BatchNorm and a linear layer,
    added as a model file, a configuration, a mix, limits and manifest
    entries, trains in a tiny cell on the CPU and passes its check."""
    root = tmp_path / "checkout"
    bench = root / "perfbench"
    shutil.copytree(tiny.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    (bench / "models" / "TinyNet.py").write_text(TOY)
    conf = json.loads((bench / "configs" / "world2-proxy-512.json").read_text())
    conf.update(name="world2-tinynet-64", resolution=[64, 64],
                model={"backbone": "TinyNet", "features": 8, "body_dtype": "float32",
                       "head_dtype": "float32"})
    (bench / "configs" / "world2-tinynet-64.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "mixes" / "train-b32.json").read_text())
    mix.update(batch=2)
    (bench / "mixes" / "train-b2.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits" / "world2-proxy-512.train-b32.json",
                bench / "limits" / "world2-tinynet-64.train-b2.json")
    man = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "world2-tinynet-64", "source": man["configs"][0]["source"],
                           "file": "perfbench/configs/world2-tinynet-64.json",
                           "reduced": ["resolution", "model"], "why": "a test's toy model"})
    man["workloads"].append({"name": "world2-tinynet-64.train-b2", "config": "world2-tinynet-64",
                             "traffic": "train-b2", "chips": 1, "why": "a test's toy cell"})
    for m in man["end_to_end"]:
        if "workloads" in m and "world2-proxy-512.train-b32" in m["workloads"]:
            m["workloads"].append("world2-tinynet-64.train-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(bench / "tests"), str(tiny.ROOT)]))
    out = subprocess.run([sys.executable, "-c", RUN_TOY], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["result"]["correct"], res["checks"]
    assert set(res["result"]["metrics"]) == {"train_img_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before, "a file of the benchmark was edited"
