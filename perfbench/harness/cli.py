"""``run.py``'s command line: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It refuses to run (exit 2, no result) without as many CUDA cards as the
cell asks for; a cell of several cards runs one rank a card, this process
rank 0 (``ranks``). With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
profiled sub-window by the readers in ``metrics/``.
"""

from __future__ import annotations

import argparse
import math
import sys

from . import manifest, session

DRIVERS = {"generate": "generate", "train": "training"}


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _number(v):
    """A JSON number: inf and nan as the largest float, so every parser
    reads the line."""
    return v if math.isfinite(v) else 1.7976931348623157e308


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             clock: session.SetupClock, plant=None) -> tuple[dict, dict]:
    """(result, checks) of one run of ``cell`` from ``device`` (rank 0's
    card); the device check is the caller's. ``plant`` is a picklable
    callable returning a context manager that every rank's part of the run
    is made inside: a test's fault (``ranks.planted``)."""
    import importlib

    import torch

    driver = importlib.import_module(f"harness.{DRIVERS[cell.mix['kind']]}")
    metrics, extra, numbers = driver.run(cell, seed, seconds, trace, device, clock, plant=plant)
    out = {}
    if trace:
        tr = metrics["trace"]
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(tr)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": metrics[m["name"]], "unit": m["unit"]}
    from .compare import judge

    correct, checks = judge(numbers, cell.limits)
    checks = {k: {"value": _number(c["value"]),
                  "limit": None if c["limit"] is None else _number(c["limit"])}
              for k, c in checks.items()}
    dev = session.device_info(torch, device, cell.chips)
    dev["memory_peak_bytes"] = extra.pop("memory_peak_bytes", dev["memory_peak_bytes"])
    for k in ("busy_s", "window_s"):
        if k in extra:
            dev[k] = extra.pop(k)
    result = {"correct": correct, "attempted": extra.pop("batches"), "failed": 0,
              "metrics": out, "device": dev}
    if "breakdown" in extra:
        result["breakdown"] = extra.pop("breakdown")
    return result, checks


def main(argv) -> int:
    clock = session.SetupClock()
    args = parse(argv)
    session.set_environment()
    import torch

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), clock)
    return session.finish(result, checks)
