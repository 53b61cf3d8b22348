"""Tracing and timing helpers (port of the JAX ``utils/profiling.py``).

* ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace (``trace.json``, loadable in Perfetto or
  chrome://tracing) of the host and, on a card, the device.
* ``annotate(name)``: a named region that shows up inside the trace.
* ``chained_ms``: per-iteration milliseconds of a chain in which each step
  consumes the previous step's result, so no step can start before the
  one before it ends; on a card timed by CUDA events with one sync at the
  end, on the CPU by the host clock.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; write ``log_dir/trace.json`` at its end. Yields
    the ``torch.profiler.profile`` (``key_averages()`` for tables)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named trace region: ``with profiling.annotate('render'): ...``"""
    return record_function(name)


def chained_ms(step_fn: Callable, n: int = 16, args: tuple = (),
               device: str | torch.device = "cuda") -> float:
    """Per-iteration milliseconds of ``step_fn(acc, *args) -> acc``, a f32
    scalar tensor on ``device``, under a genuine sequential chain.

    ``step_fn`` must mix ``acc`` into its computation so that a step needs
    the previous one's result (add it to f32 data). One call warms up; then
    ``n`` chained calls are timed, by CUDA events around them with one
    synchronisation at the end on a card, by the host clock on the CPU."""
    device = torch.device(device)
    acc = torch.zeros((), device=device)
    float(step_fn(acc, *args))  # warm-up: builds, caches, allocator
    acc = torch.ones((), device=device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            acc = step_fn(acc, *args)
        end.record()
        end.synchronize()
        float(acc)
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        acc = step_fn(acc, *args)
    float(acc)
    return (time.perf_counter() - t0) / n * 1e3

