"""Headline benchmark: annotated 512x512 datagen frames/s on one card (the
port's counterpart of the repository's root ``bench.py``, which imports
JAX).

Each frame is the full modality set: shaded RGB, depth, instance map, 6DoF
box labels, keypoint visibility and Gaussian heatmap targets, made by
``Pipeline.make_generate_fn`` (on the card: the pixel-sweep, RGB and
heatmap kernels) with no host I/O in the timed region. The constants, the
consumer and the printed line are the JAX benchmark's.

Baseline: the reference's implied throughput is <= 0.15 frames/s
(BASELINE.md, "Implied reference throughput"); ``vs_baseline`` = frames/s
/ 0.15.

    python -m constructionsceneposeestimation_tpu_torch.cli bench

prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}. It runs on
the card and raises where there is none; ``run(..., device="cpu")`` takes
the CPU only when asked (the tests, at 64^2).
"""

from __future__ import annotations

import itertools
import json

import torch

from .config import Config, PipelineConfig
from .parallel import pipeline as pipeline_mod
from .utils import profiling

REFERENCE_FPS = 0.15
BATCH = 512
STEPS = 4
SIZE = 512
METRIC = "annotated_512x512_frames_per_sec_per_chip"


def consume(b: pipeline_mod.FrameBatch) -> torch.Tensor:
    """A f32 device scalar that reads every modality with a full reduction,
    the JAX benchmark's ``consume`` term by term: 14 fields (``frame_id``
    and ``inst_visible`` left out), non-finite float values counted as 0,
    integer and boolean fields summed as f32. Integer sums accumulate in
    int64, where JAX's int32 sum of ``instance`` wraps at 512 frames; the
    value only feeds the chain."""
    f32 = torch.float32

    def fin(x):
        return torch.where(torch.isfinite(x), x, 0.0).sum()

    def count(x):
        return x.sum().to(f32)

    return (fin(b.depth) + b.rgb.sum(dtype=f32) + count(b.instance) + b.heatmaps.sum()
            + fin(b.kpt_uv) + count(b.kpt_visible) + count(b.kpt_in_image)
            + fin(b.center) + fin(b.size) + fin(b.euler_deg) + count(b.bbox2d)
            + fin(b.camera_pose7) + count(b.inst_pixel_count) + count(b.pointcloud_count))


def run(batch: int = BATCH, steps: int = STEPS, size: int = SIZE,
        device: str | torch.device = "cuda") -> dict:
    """``profiling.time_chain`` over generate calls: a warm-up chain of
    ``steps`` calls (builds the kernels, fills the allocator), then
    ``steps`` more timed. Each step generates frames ``range(batch)`` from a
    seed of its own (the warm-up's seeds 0..steps-1, the timed ones
    steps..2*steps-1) and adds ``consume(batch) * 1e-12`` to a device
    scalar; the stream orders the steps, and the host synchronises once, at
    the end.

    Returns ``ms`` (the timed chain: CUDA events on the card, the host
    clock on the CPU), ``host_ms`` (the host clock over the same region),
    ``fps`` = batch / (ms / steps / 1000), ``peak_bytes``
    (``torch.cuda.max_memory_allocated`` over both chains, None on the
    CPU) and ``total`` (the chain's scalar)."""
    device = torch.device(device)
    card = device.type == "cuda"
    if card and not torch.cuda.is_available():
        raise RuntimeError("bench runs on the card, and torch.cuda.is_available() is false")
    cfg = Config(pipeline=PipelineConfig(render_width=size, render_height=size,
                                         batch_size=batch))
    gen = pipeline_mod.Pipeline(cfg, device=device).make_generate_fn(ladder=False)
    ids = range(batch)
    seeds = itertools.count()

    def step(acc):
        return acc + consume(gen(next(seeds), ids)) * 1e-12

    if card:
        torch.cuda.reset_peak_memory_stats(device)
    ms, host_ms, total = profiling.time_chain(step, steps, device=device, warmup=steps)
    return {"ms": ms, "host_ms": host_ms, "fps": batch / (ms / steps / 1000.0),
            "peak_bytes": torch.cuda.max_memory_allocated(device) if card else None,
            "total": total, "batch": batch, "steps": steps, "size": size}


def main(device: str | torch.device = "cuda") -> dict:
    """Run the benchmark at the JAX shapes, print its one JSON line and
    return ``run``'s result."""
    res = run(device=device)
    # vs_baseline from the rounded value, so a reader can recompute it.
    value = round(res["fps"], 2)
    print(json.dumps({"metric": METRIC, "value": value, "unit": "frames/s",
                      "vs_baseline": round(value / REFERENCE_FPS, 1)}), flush=True)
    return res


if __name__ == "__main__":
    main()
