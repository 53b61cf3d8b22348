"""``utils/profiling.py`` of the port: ``trace`` writes a Chrome trace that
holds the regions ``annotate`` names, and ``chained_ms`` times a chain of
steps that each consume the previous result (on the CPU by the host
clock; the card's case, timed by CUDA events, is in
tests/test_torch_cuda.py)."""

import json

import torch

from constructionsceneposeestimation_tpu_torch.utils import profiling


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
