"""Multi-GPU data parallelism on ``torch.distributed`` (port of the JAX
``parallel/mesh.py``).

A 1-D mesh of ranks over the ``data`` axis: datagen is embarrassingly
parallel (a frame depends only on the seed, its id and its scene group),
so each rank generates its contiguous rows of a batch and nothing is
communicated; training is data parallel, its gradients averaged over the
ranks by DDP, or by FSDP2 (``fully_shard``) with the parameters and the
AdamW state sharded over the same axis (``TrainConfig.fsdp``).

The backend is NCCL for CUDA devices and gloo for the CPU, unless the
caller names one (gloo also runs on CUDA tensors: two ranks on one card,
which NCCL refuses). Each process drives one device, the one its caller
names or ``cuda:LOCAL_RANK``.

The dry run (``dryrun_multigpu``, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``) runs under ``torchrun``:

    torchrun --nproc_per_node 4 -m constructionsceneposeestimation_tpu_torch.parallel.mesh \\
        --dryrun
    torchrun --nproc_per_node 2 -m constructionsceneposeestimation_tpu_torch.parallel.mesh \\
        --dryrun --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
DRYRUN_GEN_SIZE = 256  # the JAX dry run's raster for the production generate


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None,
                           device: str | torch.device = "cuda") -> torch.device:
    """Join the process group; returns this rank's device.

    With no ``coordinator`` the group comes from torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with one
    (``host:port``) from ``tcp://`` initialisation with ``num_processes``
    and ``process_id``. ``device`` "cuda" without an index means
    ``cuda:LOCAL_RANK`` (or the process id); the backend is NCCL for a
    CUDA device and gloo for the CPU unless ``backend`` names one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id or 0)))
        # Set before the group and the mesh exist, so neither picks a device.
        torch.cuda.set_device(dev)
        torch.cuda.init()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    return dev


def make_mesh(n_devices: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """The 1-D ``data`` mesh over the process group's ``n_devices`` ranks
    (all of them by default; a mesh over part of the group is refused)."""
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a {n}-rank mesh in a group of {world}: the data mesh spans the group")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(DATA_AXIS,))


def batch_sharding(mesh: DeviceMesh, batch: int) -> range:
    """This rank's contiguous rows of a batch of ``batch``: rank r of n holds
    rows [r b / n, (r + 1) b / n). A batch the ranks cannot split evenly is
    refused."""
    n, r = mesh.size(), mesh.get_local_rank(DATA_AXIS)
    if batch % n:
        raise ValueError(f"a batch of {batch} does not split over {n} ranks")
    per = batch // n
    return range(r * per, (r + 1) * per)


def shard_params_fsdp(mesh: DeviceMesh, model: torch.nn.Module) -> torch.nn.Module:
    """FSDP2 ``fully_shard`` of ``model`` over the data axis, in place, by
    the JAX leaf rule: a parameter of two or more dimensions is sharded on
    its largest axis where that axis divides by the ranks. The JAX rule
    replicates every other parameter (vectors, and tensors whose largest
    axis does not divide); FSDP2 keeps no replicated parameter in a sharded
    group, so those take its default, dim 0, padded where it does not
    divide. That changes where the values live, not what is computed. The
    AdamW state follows the parameters' placements, as the JAX rule shards
    the optimizer state leaf for leaf. FSDP2 shards only contiguous
    tensors, so the card's channels-last convolution weights are made
    contiguous first."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    model.to(memory_format=torch.contiguous_format)
    n = mesh.size()

    def placement(p: torch.nn.Parameter):
        if p.ndim >= 2:
            axis = max(range(p.ndim), key=lambda a: p.shape[a])
            if p.shape[axis] % n == 0:
                return Shard(axis)
        return None  # FSDP2's default, Shard(0)

    return fully_shard(model, mesh=mesh, shard_placement_fn=placement)


def gather_rows(batch, mesh: DeviceMesh):
    """Every rank's rows of a ``FrameBatch`` (or any NamedTuple of tensors
    split by ``batch_sharding``) on every rank, in frame order."""
    group = mesh.get_group(DATA_AXIS)
    out = []
    for v in batch:
        x = v.contiguous()
        flat = x.view(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(flat) for _ in range(mesh.size())]
        dist.all_gather(parts, flat, group=group)
        whole = torch.cat(parts)
        out.append(whole.view(torch.bool) if x.dtype == torch.bool else whole)
    return type(batch)(*out)


def _say(line: str) -> None:
    """Print ``line`` in one write: the ranks under torchrun share a pipe."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def dryrun_multigpu(n: int, device: str | torch.device = "cuda") -> None:
    """On an initialized group of ``n`` ranks: one FSDP training step (the
    lite model at 32^2, a batch of n, focal) whose loss is printed; then the
    production generate at 256^2 sharded 2 frames a rank, gathered,
    every field held bit for bit against this rank's single-device generate
    of the same 2-frame chunks (a batch of another shape may round some
    floats differently, on one device too, so the chunks are the reference)."""
    from ..config import Config, PipelineConfig, SceneConfig, TrainConfig
    from ..models import pose_net
    from ..train import loop as train_loop
    from .pipeline import Pipeline

    dev = torch.device(device)
    mesh = make_mesh(n, dev.type)
    rank = dist.get_rank()
    cfg = Config(scene=SceneConfig(n_cones=2, n_trees=1, n_fence_panels=4),
                 pipeline=PipelineConfig(render_width=32, render_height=32, batch_size=n),
                 train=TrainConfig(batch_size=n, steps=2, warmup_steps=1, loss="focal",
                                   fsdp=True))
    model = pose_net.make_model(lite=True, device=dev, seed=0)
    step, mesh, place = train_loop.make_sharded_train_step(cfg, model, Pipeline(cfg, device=dev),
                                                           mesh)
    state = place(train_loop.create_train_state(cfg, model))
    state, metrics = step(state, 1, range(n))
    loss = float(metrics["loss"])
    if loss != loss:
        raise RuntimeError("dryrun_multigpu: the loss is NaN")
    if rank == 0:
        _say(f"dryrun_multigpu({n}): ok, loss={loss:.5f}")

    size = DRYRUN_GEN_SIZE
    gpipe = Pipeline(Config(pipeline=PipelineConfig(render_width=size, render_height=size,
                                                    batch_size=2 * n)), device=dev)
    sharded, mesh = gpipe.make_sharded_generate(mesh)
    ids = list(range(2 * n))
    with torch.no_grad():
        got = gather_rows(sharded(7, ids), mesh)
        gen = gpipe.make_generate_fn()
        chunks = [gen(7, ids[i:i + 2]) for i in range(0, 2 * n, 2)]
    ref = type(got)(*(torch.cat(parts) for parts in zip(*chunks)))
    bad = [f for f, a, b in zip(got._fields, got, ref)
           if a.shape != b.shape or not torch.equal(a.view(-1).view(torch.uint8),
                                                    b.view(-1).view(torch.uint8))]
    if bad:
        raise RuntimeError(f"dryrun_multigpu: rank {rank}: sharded generate differs from the "
                           f"single-device chunks on {bad}")
    if rank == 0:
        _say(f"dryrun_multigpu({n}): sharded generate bit-identical to the single-device "
             f"chunks across {len(got._fields)} modalities ({2 * n} frames at {size}x{size})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", action="store_true", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK), cuda:N (every rank on card N) or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    args = ap.parse_args(argv)
    dev = initialize_distributed(device=args.device, backend=args.backend)
    try:
        dryrun_multigpu(dist.get_world_size(), dev)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
