"""Shared by the benchmark's CPU tests: the harness on the path, and each
cell of ``BENCHMARK.json`` cut to a size a CPU test can hold (64^2 frames,
a few frames a batch or step), with its own limits."""

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
# Limits that depend on the size: at 64^2 the backbone's deepest maps are
# 2 x 2, where its bfloat16 body moves the first gradient by some 1.8% of its
# norm against float32 (the fp8 control by some 7.6%), more than at 512^2.
TINY_LIMITS = {"grad_diff": 0.04}


def cells() -> list[str]:
    return [w["name"] for w in manifest.load_manifest()["workloads"]]


def tiny(name: str, root: Path = ROOT, bench_dir: Path = BENCH) -> manifest.Cell:
    """Cell ``name`` at 64^2 with few frames; clips of 3 frames."""
    cell = manifest.load_cell(name, root, bench_dir)
    mix = dict(cell.mix, warmup_batches=1, profile_batches=1)
    if mix["kind"] == "train":
        mix.update(batch=2)
    else:
        mix.update(batch=4, check_frames=2)
        if mix.get("sequence_len"):
            mix.update(batch=6, sequence_len=3)
    limits = {k: TINY_LIMITS.get(k, v) for k, v in cell.limits.items()}
    return cell._replace(config=dict(cell.config, resolution=[64, 64]), mix=mix, limits=limits)


def run(cell: manifest.Cell, trace: bool = False, seconds: float = 0.5):
    """One run of ``cell`` on the CPU: (result, checks)."""
    import torch

    from harness import cli, session

    return cli.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), session.SetupClock())
