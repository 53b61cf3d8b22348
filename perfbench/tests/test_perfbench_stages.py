"""The readers of the port's own spans (``harness/stages.py``) on a trace
written by hand: two batches of 500 us, each with nested ``gen.*`` spans,
kernels that leave known gaps, and a synchronising call inside
``gen.render`` (with one in ``gen.sample.upload`` that the render's count
leaves out). The same trace with the harness's outer spans alone, as a
program without spans gives, reads nothing."""

import pytest

import perfbench_tiny  # noqa: F401 (puts the harness on the path)
from harness import manifest, tracing

STAGE_READERS = [m["name"] for m in manifest.load_manifest()["per_layer"]
                 if m["name"].split(".")[0] in ("idle_in_sampling_ms", "idle_in_render_ms",
                                                "sample_draws_host_ms",
                                                "render_syncs_per_batch")]
# per batch: idle 80 us in gen.sample.draws and 10 in gen.sample.scene; 30
# in gen.render.sweep and 100 in gen.render itself; draws 145 us; 1 sync
EXPECTED = {"idle_in_sampling_ms": 0.090, "idle_in_render_ms": 0.130,
            "sample_draws_host_ms": 0.145, "render_syncs_per_batch": 1.0}
PROGRAM = (("gen.batch", 5, 495), ("gen.sample", 5, 200), ("gen.sample.draws", 5, 150),
           ("gen.sample.upload", 150, 170), ("gen.sample.scene", 170, 200),
           ("gen.render", 200, 495), ("gen.render.sweep", 210, 300),
           ("gen.render.labels", 300, 400))
HARNESS = ((tracing.BATCH, 0, 500), ("sample_inputs", 4, 201), ("render", 199, 496))
KERNELS = ((100, 175), (185, 250), (280, 360), (460, 520))
SYNCS = ((160, 165), (350, 355))


def _x(cat, name, a, b, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(a), "dur": float(b - a), **kw}


def _trace(program=True):
    ev = [_x("user_annotation", tracing.WINDOW, 0, 1000), _x("kernel", "drain", 0, 20)]
    for o in (0, 500):
        spans = HARNESS + (PROGRAM if program else ())
        ev += [_x("user_annotation", n, o + a, o + b, tid=1) for n, a, b in spans]
        ev += [_x("kernel", "k", o + a, min(o + b, 1000)) for a, b in KERNELS]
        ev += [_x("cuda_runtime", "cudaStreamSynchronize", o + a, o + b) for a, b in SYNCS]
    return tracing.Trace(ev, 2, tracing.Spans(), 2, frozenset())


def test_the_hand_written_trace_has_the_gaps_it_is_built_with():
    tr = _trace()
    assert tr.idle_gaps() == [(20, 100), (175, 185), (250, 280), (360, 460),
                              (520, 600), (675, 685), (750, 780), (860, 960)]
    assert tr.syncs() == 4


def test_the_stage_readers_are_in_the_manifest():
    assert len(STAGE_READERS) == 10


@pytest.mark.parametrize("name", STAGE_READERS)
def test_stage_reader_reads_its_exact_number(name):
    assert manifest.reader(name)(_trace()) == pytest.approx(EXPECTED[name.split(".")[0]],
                                                            abs=1e-12)


@pytest.mark.parametrize("name", STAGE_READERS)
def test_stage_reader_reads_nothing_without_the_program_spans(name):
    assert manifest.reader(name)(_trace(program=False)) is None


def test_breakdown_names_the_stages():
    gaps = dict(_trace().breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"idle during gen.sample.draws": 160e-6,
                                  "idle during gen.sample.scene": 20e-6,
                                  "idle during gen.render.sweep": 60e-6,
                                  "idle during gen.render": 200e-6})



def test_allreduce_exposed_reads_its_exact_number():
    """NCCL kernels in two batches of 500 us: 20 us under a compute kernel
    and 50 alone; 40 with 10 of compute inside; two that overlap each other
    over 150 us with 20 of compute inside: 210 us exposed, 0.105 ms a
    batch. Without NCCL kernels the reader finds nothing."""
    nccl = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    ev = [_x("user_annotation", tracing.WINDOW, 0, 1000),
          _x("kernel", "conv", 0, 100), _x("kernel", nccl, 80, 150),
          _x("kernel", nccl, 300, 340), _x("kernel", "add", 320, 330),
          _x("kernel", nccl, 500, 600), _x("kernel", nccl, 550, 650),
          _x("kernel", "mul", 600, 620)]
    read = manifest.reader("allreduce_exposed_ms.train")
    assert read(tracing.Trace(ev, 2, tracing.Spans(), 2, frozenset())) == pytest.approx(
        0.105, abs=1e-12)
    plain = [e for e in ev if "nccl" not in e["name"]]
    assert read(tracing.Trace(plain, 2, tracing.Spans(), 2, frozenset())) is None
