"""Cells of generated frames: i.i.d. batches through
``Pipeline.make_generate_fn(ladder=False)``, or clips through
``make_sequence_fn(sequence_len)``, each batch consumed on the device.

Batch i holds frames ``i * B .. (i + 1) * B - 1``, frame ids running on
from the warm-up batches through the window; every call takes the run's
seed. A few frames of the window, drawn from the seed, are kept and held
against the plain reference after the window has closed.
"""

from __future__ import annotations

import random
import sys

import torch

from . import compare, configure, ranks, tracing, window as win
from .manifest import Cell
from .session import SetupClock

PACKAGE = "constructionsceneposeestimation_tpu_torch"


class Sample:
    """A reservoir of ``k`` frames drawn from the seed over all batches of the
    window: each batch offers one row, kept with probability k / (batches so
    far), so the kept frames are a uniform draw whatever the count."""

    def __init__(self, seed: int, k: int, batch: int):
        self.rng = random.Random(seed)
        self.k, self.batch, self.seen = k, batch, 0
        self.rows: list = []

    def offer(self, fb) -> None:
        row = self.rng.randrange(self.batch)
        slot = self.seen if self.seen < self.k else self.rng.randrange(self.seen + 1)
        self.seen += 1
        if slot < self.k:
            kept = type(fb)(*(v[row:row + 1].clone() for v in fb))
            if slot < len(self.rows):
                self.rows[slot] = kept
            else:
                self.rows.append(kept)

    def batch_of(self):
        """The kept frames as one batch, in frame order."""
        rows = sorted(self.rows, key=lambda b: int(b.frame_id[0]))
        return type(rows[0])(*(torch.cat(f) for f in zip(*rows)))


def _generate_fn(pipe, mix):
    L = mix.get("sequence_len", 0)
    return pipe.make_sequence_fn(L) if L else pipe.make_generate_fn(ladder=False)


def reference_frames(cell: Cell, seed: int, frame_ids, device, control: bool = False,
                     noise_ends: bool = False):
    """The plain reference's frames ``frame_ids`` of the cell's traffic, on
    ``device``; ``control`` computes them as the control does, its matrix
    products in TF32 and its RGB pass in bfloat16 (``reference/precision``).
    With ``noise_ends``, (frames, lo, hi): beside the frames, their RGB with
    the hash noise held at either end (``reference/noise``)."""
    import contextlib

    from reference import noise, precision
    from reference.plain import config as ref_config
    from reference.plain.parallel import pipeline as ref_pipeline

    cfg = configure.make_config(ref_config, cell.config, cell.mix)
    pipe = ref_pipeline.Pipeline(cfg, device=device, **cell.config["tier"])
    held: dict = {}
    with torch.no_grad(), (precision.control() if control else contextlib.nullcontext()), \
            (noise.noise_ends(held) if noise_ends else contextlib.nullcontext()):
        frames = _generate_fn(pipe, cell.mix)(seed, frame_ids)
    if not noise_ends:
        return frames
    return frames, torch.cat(held["lo"]), torch.cat(held["hi"])


class Stream:
    """The port's generate call for a cell on ``device``, a consumer chain
    on the device, and the batch index that runs on from call to call."""

    def __init__(self, cell: Cell, device: torch.device):
        from constructionsceneposeestimation_tpu_torch import config as port_config
        from constructionsceneposeestimation_tpu_torch.parallel import pipeline as port_pipeline

        self.B = cell.mix["batch"]
        cfg = configure.make_config(port_config, cell.config, cell.mix)
        self.pipe = port_pipeline.Pipeline(cfg, device=device, **cell.config["tier"])
        self.gen = _generate_fn(self.pipe, cell.mix)
        self.acc = torch.zeros((), device=device)
        self.next = 0

    def batch(self, seed: int, offer=None) -> None:
        i, self.next = self.next, self.next + 1
        fb = self.gen(seed, range(i * self.B, (i + 1) * self.B))
        self.acc = self.acc + compare.consume(fb) * 1e-12
        if offer is not None:
            offer(fb)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        clock: SetupClock, plant=None):
    """(metrics, extra result keys, compared numbers) of one run, made
    inside ``plant`` (``ranks.planted``); prints its set-up parts on
    standard error. A generate cell runs on one card."""
    if cell.chips != 1:
        raise ValueError(f"{cell.name}: a generate cell runs on one card")
    with ranks.planted(plant):
        return _run(cell, seed, seconds, trace, device, clock)


def _run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
         clock: SetupClock):
    import importlib

    mix, card = cell.mix, device.type == "cuda"
    B = mix["batch"]
    clock.mark("import")
    if card:
        torch.cuda.init()
        torch.zeros(1, device=device)
        clock.mark("cuda_context")
        importlib.import_module(f"{PACKAGE}.utils.kernels").library()
        clock.mark("kernel_load")
    stream = Stream(cell, device)
    clock.mark("tables")
    for _ in range(mix["warmup_batches"]):
        stream.batch(seed)
    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    clock.mark("warmup")
    setup_s = clock.total()

    spans = tracing.Spans().install() if trace else None
    sample = Sample(seed, mix["check_frames"], B)
    ends = win.run(win.Window(device), seconds, lambda i: stream.batch(seed, sample.offer))
    n = len(ends)
    peak = int(torch.cuda.max_memory_allocated(device)) if card else 0
    if trace:
        from . import roofline

        with roofline.capture() as bounds, tracing.profiled(device) as held:
            for _ in range(mix["profile_batches"]):
                bounds.next_batch()
                with torch.profiler.record_function(tracing.BATCH):
                    stream.batch(seed)
        spans.remove()
        tr = tracing.Trace(held.events, mix["profile_batches"], spans, n,
                           tracing.handwritten_kernels(),
                           {"kernel_bound_ms": bounds.total_ms(),
                            "window_frames_per_s": n * B / (ends[-1] * 1e-3)})
        metrics = {"trace": tr}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s, "breakdown": tr.breakdown()}
    else:
        gap = win.gaps(ends)
        metrics = {"frames_per_s": n * B / (ends[-1] * 1e-3),
                   "batch_ms_p95": win.percentile(gap, 95.0), "setup_s": setup_s}
        extra = {}
        print(f"[window] {n} batches of {B} frames in {ends[-1]:.1f} ms; batch ms median "
              f"{win.percentile(gap, 50.0):.3f}, p95 {win.percentile(gap, 95.0):.3f}",
              file=sys.stderr)
    float(stream.acc)  # the chain's value, read once the window has closed
    prog = sample.batch_of()
    del stream
    if card:
        torch.cuda.empty_cache()
    ref, lo, hi = reference_frames(cell, seed, prog.frame_id.tolist(), device, noise_ends=True)
    extra.update(memory_peak_bytes=peak, batches=n)
    return metrics, extra, compare.frame_numbers(prog, ref, (lo, hi))
