"""The port's multi-GPU layer (``parallel/mesh.py``,
``Pipeline.make_sharded_generate``, ``train/loop.make_sharded_train_step``)
on a real 2-process group on the CPU: gloo, workers started as
subprocesses on a free localhost port, as tests/test_distributed.py starts
the JAX package's.

Each worker runs ``tools/check_sharded_step.py --dryrun``: the dry run's
FSDP step and its sharded generate at 256^2, gathered and held bit for
bit against the single-device generate of the same 2-frame chunks; then
the DDP and FSDP steps, focal and MSE, against the single-process step on
the same global batch (each step's loss to 1e-5 relative, the parameters
after 2 steps to 1e-5 on 99% of the weights and all within 2 lr; the
tool's docstring says why); and ``batch_sharding`` refusing a ragged
batch. The group runs once for the module (about 20 s)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import pytest
import torch
import torch.distributed as dist

from constructionsceneposeestimation_tpu_torch.parallel import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]
CASES = ("ddp-focal", "ddp-mse", "fsdp-focal", "fsdp-mse")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group():
    """The two workers' exit codes and printed lines."""
    coord = f"localhost:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "check_sharded_step.py"), "--device", "cpu",
         "--dryrun", "--coordinator", coord, "--world", "2", "--rank", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append((p.wait(timeout=300), p.communicate()[0].splitlines()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return outs


def _records(lines):
    return [json.loads(ln) for ln in lines if ln.startswith("{")]


def test_workers_exit_cleanly(group):
    for rc, lines in group:
        assert rc == 0, "\n".join(lines[-30:])


def test_sharded_generate_bit_identical_to_chunks(group):
    lines = group[0][1]
    assert "dryrun_multigpu(2): ok, loss=" in "\n".join(lines)
    assert ("dryrun_multigpu(2): sharded generate bit-identical to the single-device chunks "
            "across 16 modalities (4 frames at 256x256)") in lines


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_single_process(group, case):
    for rank, (_, lines) in enumerate(group):
        rec = [r for r in _records(lines) if r.get("case") == case]
        assert len(rec) == 1, lines[-30:]
        r = rec[0]
        assert (r["rank"], r["world"], r["backend"]) == (rank, 2, "gloo")
        assert max(r["loss_rel"]) <= 1e-5 and r["param_share_over_1e-5"] <= 0.01, r
        assert r["param_max_abs"] <= 2e-3 and r["ok"], r


def test_batch_sharding_refuses_a_ragged_batch(group):
    for rank, (_, lines) in enumerate(group):
        assert {"rank": rank, "ragged_batch_refused": True} in _records(lines)


class Rows(NamedTuple):
    x: torch.Tensor
    flag: torch.Tensor


def test_single_rank_mesh_in_process():
    """A 1-rank gloo group in this process: the mesh spans it, every row is
    this rank's, gathering is the identity, and a mesh over more ranks than
    the group is refused."""
    dev = mesh_mod.initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
        m = mesh_mod.make_mesh(device_type="cpu")
        assert m.mesh_dim_names == (mesh_mod.DATA_AXIS,) and m.size() == 1
        assert mesh_mod.batch_sharding(m, 5) == range(5)
        rows = Rows(torch.arange(6.0).reshape(3, 2), torch.tensor([True, False, True]))
        got = mesh_mod.gather_rows(rows, m)
        assert isinstance(got, Rows) and all(torch.equal(a, b) for a, b in zip(got, rows))
        with pytest.raises(ValueError):
            mesh_mod.make_mesh(2, "cpu")
    finally:
        dist.destroy_process_group()
