#!/usr/bin/env python3
"""Hold the port's data-parallel training step against the single-process
step on the same global batch, on every rank of a ``torch.distributed``
group; with ``--dryrun``, first run ``parallel/mesh.dryrun_multigpu`` (the
FSDP step and the sharded generate, bit for bit against the per-chunk
single-device rows).

    torchrun --nproc_per_node 2 tools/check_sharded_step.py --device cpu --dryrun
    python -m torch.distributed.run --nproc_per_node 2 tools/check_sharded_step.py \\
        --device cuda:0 --backend gloo --cases ddp-focal
    python tools/check_sharded_step.py --device cpu --coordinator localhost:PORT \\
        --world 2 --rank R            # one process of the group, started by hand

Each case (``--cases``: ddp or fsdp, focal or mse) trains the lite model in
f32 for 2 steps at 32^2 (warmup 1, so the first update has lr 0 and the
second lr 1e-3) on a global batch of 2 frames a rank: the reference runs
``make_train_step`` on the whole batch in this process, the sharded step
``make_sharded_train_step`` on this rank's rows. Tolerances: each step's
loss to 1e-5 relative; the parameters after the 2 steps to 1e-5 on at
least 99% of the weights and every weight within 2 lr (Adam moves a weight
by about lr whatever its gradient's size, so a weight whose gradient is
within rounding of 0 may move either way). Each rank of a group of two or
more also checks that ``batch_sharding`` refuses a batch the ranks cannot
split. Prints one JSON
line a case from each rank and exits 1 if any check failed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from constructionsceneposeestimation_tpu_torch.config import (  # noqa: E402
    Config, PipelineConfig, TrainConfig)
from constructionsceneposeestimation_tpu_torch.models import pose_net  # noqa: E402
from constructionsceneposeestimation_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline  # noqa: E402
from constructionsceneposeestimation_tpu_torch.train import loop as train_loop  # noqa: E402

SIZE, STEPS, LR = 32, 2, 1e-3


def emit(record: dict) -> None:
    """One JSON line in one write: ranks under torchrun share a pipe, and
    a line written in two parts interleaves with the other rank's."""
    sys.stdout.write(json.dumps(record) + "\n")
    sys.stdout.flush()


def params(model) -> dict:
    """Full parameter values by name on the host. FSDP2's shards are
    gathered as host tensors (``all_gather_object``): ``DTensor.full_tensor``
    over gloo on CUDA tensors ends the process with a segmentation fault
    (torch 2.11, H100)."""
    model = getattr(model, "module", model)  # DDP
    out = {}
    for n, p in model.named_parameters():
        if isinstance(p, DTensor):
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, p.to_local().detach().cpu())
            out[n] = torch.cat(parts, dim=p.placements[0].dim).float()
        else:
            out[n] = p.detach().float().cpu()
    return out


def run_case(case: str, dev: torch.device, mesh) -> dict:
    wrap, loss = case.split("-")
    n = mesh.size()
    cfg = Config(pipeline=PipelineConfig(render_width=SIZE, render_height=SIZE),
                 train=TrainConfig(batch_size=2 * n, steps=STEPS, warmup_steps=1,
                                   learning_rate=LR, loss=loss, fsdp=wrap == "fsdp"))
    pipe = Pipeline(cfg, device=dev)
    make = lambda: pose_net.make_model(lite=True, device=dev, seed=0, dtype=torch.float32)
    ref_state = train_loop.create_train_state(cfg, make())
    ref_step = train_loop.make_train_step(cfg, ref_state.model, pipe)
    model = make()
    step, mesh, place = train_loop.make_sharded_train_step(cfg, model, pipe, mesh)
    state = place(train_loop.create_train_state(cfg, model))
    losses_rel = []
    for i in range(STEPS):
        ids = range(i * 2 * n, (i + 1) * 2 * n)
        ref_state, ref_m = ref_step(ref_state, 3, ids)
        state, m = step(state, 3, ids)
        a, b = float(m["loss"]), float(ref_m["loss"])
        losses_rel.append(abs(a - b) / abs(b))
    got, want = params(state.model), params(ref_state.model)
    d = torch.cat([(got[k] - want[k]).abs().reshape(-1) for k in want])
    out = {"case": case, "rank": dist.get_rank(), "world": n, "device": str(dev),
           "backend": dist.get_backend(), "loss_rel": losses_rel,
           "param_max_abs": float(d.max()), "param_share_over_1e-5": float((d > 1e-5).float().mean()),
           "n_params": int(d.numel())}
    out["ok"] = (max(losses_rel) <= 1e-5 and out["param_share_over_1e-5"] <= 0.01
                 and out["param_max_abs"] <= 2 * LR and got.keys() == want.keys())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--cases", default="ddp-focal,ddp-mse,fsdp-focal,fsdp-mse")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--coordinator", default=None, help="host:port, with --world and --rank")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_mod.initialize_distributed(args.coordinator, args.world, args.rank,
                                          backend=args.backend, device=args.device)
    ok = True
    try:
        mesh = mesh_mod.make_mesh(device_type=dev.type)
        if mesh.size() > 1:
            try:
                mesh_mod.batch_sharding(mesh, 2 * mesh.size() + 1)
                refused = False
            except ValueError:
                refused = True
            ok &= refused
            emit({"rank": dist.get_rank(), "ragged_batch_refused": refused})
        if args.dryrun:
            mesh_mod.dryrun_multigpu(mesh.size(), dev)
        for case in [c for c in args.cases.split(",") if c]:
            res = run_case(case, dev, mesh)
            ok &= res["ok"]
            emit(res)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
