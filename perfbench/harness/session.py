"""What every run shares: the clock from the process's start, the set-up
parts, the card's description, the check that no JAX module was loaded, and
the one result line.

A run prints its set-up parts and the numbers its check compared on
standard error, and one JSON object as the last line of standard output.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
# Top-level module names that may not be loaded in a run: JAX, its runtime
# and flax, and the JAX package that the port was made from. Compared whole:
# the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "constructionsceneposeestimation_tpu")
# Fixed cache directories inside the checkout, so that only a checkout's
# first run builds (the port's kernels go to build/torch_kernels by itself).
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/perfbench/triton",
              "TORCH_EXTENSIONS_DIR": "build/perfbench/torch_extensions"}


def process_start() -> float:
    """The wall-clock time at which this process started (from /proc), or
    now where /proc cannot say."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def set_environment() -> None:
    """Cache directories inside the checkout, and no JAX behind a library."""
    for key, rel in CACHE_DIRS.items():
        path = ROOT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


class SetupClock:
    """The parts of ``setup_s``, from the process's start to the first
    timed batch; each part printed on standard error as it ends."""

    def __init__(self, start: float | None = None, label: str = "setup"):
        self.start = process_start() if start is None else start
        self.label = label
        self.last = self.start
        self.parts: dict[str, float] = {}

    def mark(self, name: str) -> float:
        now = time.time()
        self.parts[name] = now - self.last
        self.last = now
        print(f"[{self.label}] {name}: {self.parts[name]:.3f} s", file=sys.stderr, flush=True)
        return self.parts[name]

    def total(self) -> float:
        return self.last - self.start


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_info(torch, device, count: int = 1) -> dict:
    """The ``device`` entry of the result line."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": power_limit()}


def finish(result: dict, checks: dict) -> int:
    """Print the compared numbers beside their limits on standard error, then
    the result line (its ``checks`` key last) on standard output; 1 and no
    result where a forbidden module was loaded."""
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps({**result, "checks": checks}), flush=True)
    return 0
