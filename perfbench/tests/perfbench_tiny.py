"""Shared by the benchmark's CPU tests: the harness on the path, and each
cell of ``BENCHMARK.json`` cut to a size a CPU test can hold (64^2 frames,
a few frames a batch or step, a cell of several cards on two gloo ranks),
with its own limits."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest  # noqa: E402

SEED = 2 ** 33 + 17  # a seed beyond 32 bits, as the driver's are
# Limits that depend on the size, each the larger of the cell's and this: at
# 64^2 the backbone's deepest maps are 2 x 2, where its bfloat16 body moves
# the first gradient by some 1.8% of its norm against float32 (the fp8
# control by some 7.6%), and two frames a rank move each leaf's gradient and
# change by up to 2% and 1.5%, more than at 512^2.
TINY_LIMITS = {"grad_diff": 0.04, "grad_gap": 0.06, "change_gap": 0.05}


def cells() -> list[str]:
    return [w["name"] for w in manifest.load_manifest()["workloads"]]


def tiny(name: str, root: Path = ROOT, bench_dir: Path = BENCH) -> manifest.Cell:
    """Cell ``name`` at 64^2 with few frames; clips of 3 frames; two
    frames a rank, on two ranks where the cell asks for several cards."""
    cell = manifest.load_cell(name, root, bench_dir)
    cell = cell._replace(chips=min(cell.chips, 2))
    mix = dict(cell.mix, warmup_batches=1, profile_batches=1)
    if mix["kind"] == "train":
        mix.update(batch=2 * cell.chips)
    else:
        mix.update(batch=4, check_frames=2)
        if mix.get("sequence_len"):
            mix.update(batch=6, sequence_len=3)
    limits = {k: max(v, TINY_LIMITS.get(k, v)) for k, v in cell.limits.items()}
    return cell._replace(config=dict(cell.config, resolution=[64, 64]), mix=mix, limits=limits)


def run(cell: manifest.Cell, trace: bool = False, seconds: float = 0.5, plant=None):
    """One run of ``cell`` on the CPU, made inside ``plant`` on every rank:
    (result, checks)."""
    import torch

    from harness import cli, session

    return cli.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), session.SetupClock(),
                        plant=plant)
