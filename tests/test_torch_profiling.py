"""``utils/profiling.py`` of the port: ``trace`` writes a Chrome trace that
holds the regions ``annotate`` names, ``time_chain`` and ``chained_ms``
time a chain of steps that each consume the previous result (on the CPU
by the host clock; the card's case, timed by CUDA events, is in
tests/test_torch_cuda.py), and ``Stopwatch`` keeps such measurements by
name (the JAX one's test, tests/test_checkpoint_utils.py, on the CPU)."""

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
