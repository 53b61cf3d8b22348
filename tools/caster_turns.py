#!/usr/bin/env python3
"""The analytic caster's calls in two checkouts, timed in turns on one GPU.

    python3 tools/caster_turns.py --against DIR [--rounds 2] [--iters 20]

DIR is another checkout of the repository, e.g. an earlier commit's ``git
archive`` unpacked under ``build/``, which git ignores. Runs a fresh
process in DIR and in this checkout in turns (DIR, this,
this, DIR, ``--rounds`` times); each builds its own kernels, samples the
same inputs from a seed and times, after a warm-up:

- ``Raycaster.packed`` on the keypoint segments of a 512-frame ``bench``
  batch (the main path's call: ``axis_sums`` and the kernel);
- ``Raycaster.cast`` on 64 x 512² pixel rays;
- ``Raycaster.fast_multi_origin`` on the shadow rays from those hits;

each call by CUDA events around ``--iters`` calls (the wrapper's host work
included) and its kernel by ``torch.profiler`` device time, and prints a
checksum of each output's bits. The medians by checkout close the run;
the checksums of the two checkouts must agree. Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# Runs inside one checkout (its root first on sys.path): one JSON line.
CHILD = r'''
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.scene import world as world_mod
iters, dev, res = int(sys.argv[1]), torch.device("cuda", 0), 512

def pipeline(n):
    return Pipeline(Config(pipeline=PipelineConfig(render_width=res, render_height=res,
                                                   batch_size=n)), device=dev)

pipe = pipeline(64)
caster = pipe.caster
inp = pipe.sample_inputs(0, range(64))
world = world_mod.build_world(pipe.roster, inp.pose)
cam = inp.cam_pos.contiguous()
px = cam_mod.pixel_rays(pipe.intr, cam_mod.look_at_matrix(cam, inp.target))
px = px.reshape(64, -1, 3).contiguous()
t = caster.cast(world, cam, px)["t"]
sun = -inp.lighting.sun_dir
so = (cam[:, None] + torch.where(torch.isfinite(t), t, 0.0)[..., None] * px
      + (sun * 1e-3)[:, None]).contiguous()
sd = sun[:, None].expand_as(px).contiguous()
inp_b = pipeline(512).sample_inputs(500, range(512))
wb = world_mod.build_world(pipe.roster, inp_b.pose)
scam = inp_b.cam_pos.contiguous()
kp = world_mod.world_keypoints(wb["inst_rot"], wb["inst_pos"], wb["kpts_local"])
seg = (kp.reshape(512, -1, 3) - scam[:, None]).contiguous()
calls = {"packed": lambda: caster.packed(wb, scam, seg),
         "cast": lambda: caster.cast(world, cam, px)["t"],
         "fast_multi_origin": lambda: caster.fast_multi_origin(world, so, sd)["t"]}
out = {"device": torch.cuda.get_device_name(0)}
for name, fn in calls.items():
    for _ in range(3):
        r = fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if "raycast_kernel" in e.key]
    n = sum(e.count for e in evs)
    out[name] = {"call_ms": e0.elapsed_time(e1) / iters,
                 "kernel_ms": sum(e.self_device_time_total for e in evs) / 1000.0 / max(n, 1),
                 "kernel_launches_seen": n,
                 "checksum": int(r.contiguous().view(torch.int32).long().sum())}
print(json.dumps(out), flush=True)
'''


def run(checkout: Path, iters: int) -> dict:
    code = f"import sys; sys.path.insert(0, {str(checkout)!r})\n" + CHILD
    proc = subprocess.run([sys.executable, "-c", code, str(iters)], cwd=checkout,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{checkout}: exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    other = args.against.resolve()
    results = {"against": [], "this": []}
    for _ in range(args.rounds):
        for side, checkout in (("against", other), ("this", ROOT), ("this", ROOT),
                               ("against", other)):
            r = run(checkout, args.iters)
            results[side].append(r)
            print(f"{side} ({checkout}): {json.dumps(r)}", flush=True)
    ok = True
    for name in ("packed", "cast", "fast_multi_origin"):
        med = {side: {k: statistics.median(r[name][k] for r in rs)
                      for k in ("call_ms", "kernel_ms")} for side, rs in results.items()}
        sums = {side: {r[name]["checksum"] for r in rs} for side, rs in results.items()}
        same = len(sums["against"] | sums["this"]) == 1
        ok = ok and same
        print(f"{name}: call {med['against']['call_ms']:.4f} -> {med['this']['call_ms']:.4f} ms, "
              f"kernel {med['against']['kernel_ms']:.4f} -> {med['this']['kernel_ms']:.4f} ms "
              f"(medians of {len(results['this'])} runs a checkout, {args.iters} calls each); "
              f"checksums of the outputs' bits equal across the checkouts: {same}", flush=True)
    print(f"on {results['this'][0]['device']}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
