"""The measured window: a closed loop with one client. The harness issues
the next batch when the call for the one before it returns, records a CUDA
event after each, and synchronises once, at the end. The window runs from
its start event to the last batch's end event."""

from __future__ import annotations

import math
import time

import torch


class Window:
    def __init__(self, device: torch.device):
        self.card = device.type == "cuda"
        self.device = device
        self.ends: list = []

    def _event(self):
        if self.card:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(self.device))
            return e
        return time.perf_counter()

    def start(self) -> None:
        self.t_start = self._event()
        self.ends.clear()

    def mark(self) -> None:
        self.ends.append(self._event())

    def finish(self) -> list[float]:
        """Synchronise, then the ms from the start to each batch's end."""
        if self.card:
            torch.cuda.synchronize(self.device)
            return [self.t_start.elapsed_time(e) for e in self.ends]
        return [(e - self.t_start) * 1e3 for e in self.ends]


def run(window: Window, seconds: float, step) -> list[float]:
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` of host time
    have passed since the window's start, marking each batch's end; returns
    ``Window.finish()``."""
    window.start()
    deadline = time.perf_counter() + seconds
    i = 0
    while True:
        step(i)
        window.mark()
        i += 1
        if time.perf_counter() >= deadline:
            break
    return window.finish()


def gaps(ends_ms: list[float]) -> list[float]:
    """The time between consecutive batch ends, the first from the start."""
    return [b - a for a, b in zip([0.0] + ends_ms[:-1], ends_ms)]


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile by the nearest rank: at least q% of the values
    lie at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
