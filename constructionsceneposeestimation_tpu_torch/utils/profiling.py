"""Tracing and timing helpers (port of the JAX ``utils/profiling.py``).

* ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace (``trace.json``, loadable in Perfetto or
  chrome://tracing) of the host and, on a card, the device.
* ``annotate(name)``: the port's span, a named region that shows up inside
  the trace, nested in the span that encloses it on the issuing thread.
  With no profiler active it costs one flag check and records nothing.
* ``time_chain``: the milliseconds of a chain in which each step consumes
  the previous step's result, so no step can start before the one before
  it ends; on a card timed by CUDA events with one sync at the end, on the
  CPU by the host clock. ``chained_ms`` gives them per iteration.
* ``Stopwatch``: a named collection of ``chained_ms`` measurements.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict

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


_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """Named trace region: ``with profiling.annotate('gen.render'): ...``.
    Under a profiler a ``record_function`` range, kept in the profiler's
    trace beside the kernels, copies and runtime calls it encloses; with
    none active one shared no-op context, so a span on the hot path costs a
    flag check."""
    return record_function(name) if _profiler_enabled() else _OFF


def time_chain(step_fn: Callable, n: int = 16, args: tuple = (),
               device: str | torch.device = "cuda", warmup: int = 1):
    """Time ``n`` calls of ``step_fn(acc, *args) -> acc``, a f32 scalar
    tensor on ``device``, under a genuine sequential chain.

    ``step_fn`` must mix ``acc`` into its computation so that a step needs
    the previous one's result (add it to f32 data). A warm-up chain of
    ``warmup`` calls from 0 builds, caches and fills the allocator; then
    ``n`` chained calls from 1 are timed, by CUDA events around them with
    one synchronisation at the end on a card, by the host clock on the CPU.

    Returns ``(ms, host_ms, total)``: the timed region's milliseconds, the
    host clock's over the same region (equal to ``ms`` on the CPU), and the
    chain's final scalar."""
    device = torch.device(device)
    acc = torch.zeros((), device=device)
    for _ in range(warmup):
        acc = step_fn(acc, *args)
    float(acc)
    acc = torch.ones((), device=device)
    card = device.type == "cuda"
    if card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if card:
        start.record()
    for _ in range(n):
        acc = step_fn(acc, *args)
    if card:
        end.record()
        end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    total = float(acc)
    return (start.elapsed_time(end) if card else host_ms), host_ms, total


def chained_ms(step_fn: Callable, n: int = 16, args: tuple = (),
               device: str | torch.device = "cuda") -> float:
    """Per-iteration milliseconds of ``time_chain(step_fn, n, args,
    device)``: one warm-up call, then ``n`` chained calls timed."""
    return time_chain(step_fn, n, args, device)[0] / n


class Stopwatch:
    """Named collection of chained measurements on one ``device`` (the
    card unless the caller asks for ``"cpu"``)."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = device
        self.results: Dict[str, float] = {}

    def measure(self, name: str, step_fn: Callable, n: int = 16) -> float:
        """``chained_ms(step_fn, n)`` on the stopwatch's device, kept under
        ``name``."""
        ms = chained_ms(step_fn, n, device=self.device)
        self.results[name] = ms
        return ms

    def report(self) -> str:
        return "\n".join(f"{k}: {v:.3f} ms" for k, v in self.results.items())
