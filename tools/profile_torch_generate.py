#!/usr/bin/env python3
"""Where the time of the PyTorch port's generate step, its evaluation step
or its training step goes, on one GPU.

    python3 tools/profile_torch_generate.py [--path generate|eval|train|generate-cli]
                                            [--batch B] [--res 512] [--out DIR]

``--path generate`` (the default) profiles ``Pipeline.make_generate_fn``;
``--path eval`` profiles ``eval/pipeline.evaluate_model`` (preprocess, the
full-width backbone in bf16, every evaluator on the GT and the model
heatmaps) on one generated batch; ``--path train`` the stage-1 training
step (``train/loop.make_train_step``: generate with camera-mix 0.3, the
augment, the full-width backbone's forward and backward, focal loss,
AdamW). ``--batch`` defaults to 64 frames, 32 for ``train``. Runs a warm-up and times 3 steps on the
host clock, then profiles 3 more with ``torch.profiler`` (CPU and CUDA
activities): prints the device time by kernel name and the device's busy
share of the profiled wall time (the profiler slows the host, so that
share is a lower bound), and writes the Chrome trace under ``--out``
(``build/profile`` of the checkout by default).
``--path generate-cli`` runs the ``generate`` command (``--format packed
--heatmaps``, 4 batches) under the profiler instead and reads its trace
for the overlap of each batch's device-to-host copy with the kernels of
the other streams: the copy of batch i should run beside the generation of
batch i+1.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=["generate", "eval", "train", "generate-cli"],
                    default="generate")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_generate: needs a CUDA device", file=sys.stderr)
        return 3
    from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                                  TrainConfig)
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

    B = args.batch or (32 if args.path == "train" else 64)
    if args.path == "generate-cli":
        return generate_cli_overlap(args, B)
    cfg = Config(pipeline=PipelineConfig(render_width=args.res, render_height=args.res,
                                         batch_size=B),
                 train=TrainConfig(batch_size=B, loss="focal", camera_mix=0.3))
    pipe = Pipeline(cfg, device="cuda")
    gen = pipe.make_generate_fn()
    if args.path == "train":
        from constructionsceneposeestimation_tpu_torch.models import pose_net
        from constructionsceneposeestimation_tpu_torch.train import loop

        holder = [loop.create_train_state(cfg, pose_net.make_model(device="cuda"))]
        train_step = loop.make_train_step(cfg, holder[0].model, pipe)

        def step(i):
            holder[0], _ = train_step(holder[0], 1, range(i * B, (i + 1) * B))
    elif args.path == "generate":
        def step(i):
            gen(0, range(i * B, (i + 1) * B))
    else:
        from constructionsceneposeestimation_tpu_torch.eval import pipeline as ev
        from constructionsceneposeestimation_tpu_torch.models import pose_net

        model = pose_net.make_model(device="cuda")
        batch = gen(1000, range(B))

        def step(i):
            ev.evaluate_model(model, batch, pipe.roster, pipe.intr,
                              cfg.pipeline.heatmap_stride, "focal", 0.15)
    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(4, 7):
        step(i)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0 / 3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(1, 4):
            step(i)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    # Device kernels only (the operator rows above them repeat their time).
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    print(f"{args.path}, without the profiler: {plain_ms:.1f} ms/batch "
          f"({B * 1000.0 / plain_ms:.1f} frames/s, host clock, 3 batches)")
    print(f"3 batches of {B} x {args.res}^2: wall {wall_ms:.1f} ms under the profiler "
          f"({wall_ms / 3:.1f} ms/batch), device busy {busy_ms:.1f} ms "
          f"({100.0 * busy_ms / wall_ms:.1f}% of wall)")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  name")
    for e in kernels[:args.top]:
        ms = e.self_device_time_total / 1000.0
        print(f"{ms:10.3f} {100.0 * ms / busy_ms:5.1f}% {e.count:6d}  {e.key[:100]}")
    n_kernels = sum(e.count for e in kernels)
    print(f"{n_kernels} kernel launches in total ({n_kernels / 3:.0f} per batch)")
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{args.path}_trace.json"))
    return 0


def generate_cli_overlap(args, B: int) -> int:
    """Profile ``cli generate --format packed --heatmaps`` over 4 batches (after
    a warm-up run) and report, from the Chrome trace, how much of each
    device-to-host copy ran while a kernel of another stream ran."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile
    from constructionsceneposeestimation_tpu_torch import cli

    work = Path(tempfile.mkdtemp(prefix="cspe_profile_generate_"))
    argv = ["generate", "--device", "cuda", "--size", str(args.res), "--batch", str(B),
            "--format", "packed", "--heatmaps"]
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "generate-cli_trace.json"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv + ["--frames", str(B), "--out", str(work / "warm")])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cli.main(argv + ["--frames", str(4 * B), "--out", str(work / "run")])
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
        prof.export_chrome_trace(str(trace))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy")]
    copies = [e for e in dev if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    copy_streams = {e["args"].get("stream") for e in copies}
    print(f"generate-cli: {4 * B} frames of {args.res}^2 in 4 batches under the profiler, "
          f"{wall_ms:.1f} ms wall; {len(copies)} device-to-host copies on streams "
          f"{sorted(copy_streams)}, kernels on streams "
          f"{sorted({e['args'].get('stream') for e in kernels})}")
    by_stream = {}
    for c in copies:
        lo, hi = c["ts"], c["ts"] + c["dur"]
        spans = sorted((max(lo, k["ts"]), min(hi, k["ts"] + k["dur"])) for k in kernels
                       if k["args"].get("stream") != c["args"].get("stream")
                       and k["ts"] < hi and k["ts"] + k["dur"] > lo)
        covered, end = 0.0, lo
        for a, b in spans:  # the union of the kernels' spans within the copy
            if b > end:
                covered += b - max(a, end)
                end = b
        n, total, beside = by_stream.get(c["args"].get("stream"), (0, 0.0, 0.0))
        by_stream[c["args"].get("stream")] = (n + 1, total + c["dur"], beside + covered)
    for stream, (n, total, beside) in sorted(by_stream.items(), key=lambda x: str(x[0])):
        own = any(k["args"].get("stream") == stream for k in kernels)
        print(f"stream {stream} ({'runs kernels too' if own else 'copies only'}): {n} "
              f"device-to-host copies, {total / 1000.0:.3f} ms in all, {beside / 1000.0:.3f} ms "
              f"of it ({100.0 * beside / max(total, 1e-9):.1f}%) while a kernel of another "
              f"stream ran")
    # When each batch's copy ran on the compute stream's timeline, and the
    # compute stream's idle gaps between batches (the loop waiting on the
    # writer thread).
    starts = sorted(k["ts"] for k in kernels)
    ends = sorted(k["ts"] + k["dur"] for k in kernels)
    spans = {}
    for c in copies:
        lo, hi = spans.get(c["args"].get("stream"), (c["ts"], c["ts"] + c["dur"]))
        spans[c["args"].get("stream")] = (min(lo, c["ts"]), max(hi, c["ts"] + c["dur"]))
    for stream, (lo, hi) in sorted(spans.items(), key=lambda x: x[1][0]):
        before = [e for e in ends if e <= lo]
        after = [t for t in starts if t >= hi]
        print(f"stream {stream}: copies from {(lo - starts[0]) / 1000.0:.3f} to "
              f"{(hi - starts[0]) / 1000.0:.3f} ms; the last kernel before them ended "
              + (f"{(lo - before[-1]) / 1000.0:.3f} ms earlier" if before else "(none)")
              + "; the next kernel started "
              + (f"{(after[0] - hi) / 1000.0:.3f} ms after them" if after else "(none)"))
    gaps = [(b - a) / 1000.0 for a, b in zip(ends[:-1], starts[1:]) if b - a > 20000]
    print(f"kernels: {sum(k['dur'] for k in kernels) / 1000.0:.3f} ms of device time over "
          f"{(ends[-1] - starts[0]) / 1000.0:.3f} ms; idle gaps above 20 ms on the kernels' "
          f"timeline: {[round(g, 1) for g in gaps]} ms")
    print(f"trace {trace.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
