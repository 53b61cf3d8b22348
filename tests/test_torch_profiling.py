"""``utils/profiling.py`` of the port: ``trace`` writes a Chrome trace that
holds the regions ``annotate`` names, ``time_chain`` and ``chained_ms``
time a chain of steps that each consume the previous result (on the CPU
by the host clock; the card's case, timed by CUDA events, is in
tests/test_torch_cuda.py), and ``Stopwatch`` keeps such measurements by
name (the JAX one's test, tests/test_checkpoint_utils.py, on the CPU).

The port's spans: ``annotate`` records nothing with no profiler active;
under ``trace`` an i.i.d. batch, a clip batch and a training step write
every span their path takes, each inside its parent on the same thread."""

import json

import pytest
import torch

from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.config import TrainConfig
from constructionsceneposeestimation_tpu_torch.models import pose_net
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.train import loop
from constructionsceneposeestimation_tpu_torch.utils import profiling

RES = 64
CFG = Config(scene=SceneConfig(n_cones=2, n_trees=1, n_fence_panels=4),
             pipeline=PipelineConfig(render_width=RES, render_height=RES),
             train=TrainConfig(batch_size=2, steps=4, warmup_steps=1, camera_mix=0.5))
# Each span of a generate batch or training step and the span it opens in.
PARENT = {
    "gen.sample": "gen.batch", "gen.sample.draws": "gen.sample",
    "gen.sample.upload": "gen.sample", "gen.sample.scene": "gen.sample",
    "gen.render": "gen.batch", "gen.render.world": "gen.render",
    "gen.render.sweep": "gen.render", "gen.render.rgb": "gen.render",
    "gen.render.labels": "gen.render", "gen.render.keypoints": "gen.render",
    "gen.render.heatmaps": "gen.render",
    "gen.batch": "train.step", "train.augment": "train.step",
    "train.forward_backward": "train.step", "train.update": "train.step",
}
GEN_SPANS = {n for n in PARENT if n.startswith("gen.")}
TRAIN_SPANS = set(PARENT) | {"train.step"}


def _pipe():
    return Pipeline(CFG, device="cpu")


def _iid(pipe):
    return pipe.make_generate_fn()(7, range(10, 12))


def _clips(pipe):
    return pipe.make_sequence_fn(4)(7, range(2, 6))


def _train(pipe):
    model = pose_net.make_model(lite=True, device="cpu", dtype=torch.float32)
    step = loop.make_train_step(CFG, model, pipe)
    step(loop.create_train_state(CFG, model), 7, range(0, 2))


def _spans(tmp_path, run):
    pipe = _pipe()
    with profiling.trace(str(tmp_path)):
        run(pipe)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_trace_writes_annotated_regions(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("cspe_render"):
            y = x @ x
        with profiling.annotate("cspe_label"):
            y.sum()
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert {"cspe_render", "cspe_label"} <= names
    assert any(e.key == "cspe_render" for e in prof.key_averages())


def test_chained_ms_on_the_cpu():
    calls = []

    def step(acc, x):
        calls.append(float(acc))
        return acc + x.sum() * 0.0 + 1.0

    ms = profiling.chained_ms(step, n=5, args=(torch.ones(8),), device="cpu")
    assert ms > 0.0
    # One warm-up from 0, then a chain from 1 that feeds each result on.
    assert calls == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]



def test_time_chain_warms_up_a_chain_on_the_cpu():
    calls = []

    def step(acc):
        calls.append(float(acc))
        return acc + 1.0

    ms, host_ms, total = profiling.time_chain(step, n=2, device="cpu", warmup=3)
    assert ms == host_ms > 0.0
    # A warm-up chain of 3 from 0, then 2 timed calls chained from 1.
    assert calls == [0.0, 1.0, 2.0, 1.0, 2.0] and total == 3.0

def test_stopwatch_on_the_cpu():
    def stepf(acc):
        g = torch.Generator().manual_seed(int(acc) % 1000)
        return acc + torch.rand(64, 64, generator=g).sum() * 1e-9

    sw = profiling.Stopwatch(device="cpu")
    ms = sw.measure("tiny", stepf, n=2)
    assert ms > 0.0 and sw.results == {"tiny": ms}
    sw.measure("again", stepf, n=3)
    assert sw.report().splitlines() == [f"tiny: {ms:.3f} ms",
                                        f"again: {sw.results['again']:.3f} ms"]
    assert profiling.Stopwatch().device == "cuda"


def test_annotate_records_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler active")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with profiling.annotate("gen.batch"):
        pass
    assert profiling.annotate("a") is profiling.annotate("b")
    fb = _iid(_pipe())
    assert fb.rgb.shape == (2, RES, RES, 3)


@pytest.mark.parametrize("path, names", [(_iid, GEN_SPANS), (_clips, GEN_SPANS),
                                         (_train, TRAIN_SPANS)],
                         ids=["iid", "clips", "train"])
def test_trace_holds_each_span_inside_its_parent(tmp_path, path, names):
    spans = _spans(tmp_path, path)
    assert names <= {e["name"] for e in spans}
    for child in (e for e in spans if e["name"] in names and e["name"] in PARENT):
        if PARENT[child["name"]] not in names:
            continue
        a, b = float(child["ts"]), float(child["ts"]) + float(child["dur"])
        assert any(p["name"] == PARENT[child["name"]] and p["tid"] == child["tid"]
                   and float(p["ts"]) <= a and b <= float(p["ts"]) + float(p["dur"])
                   for p in spans), child["name"]
