"""The traced run's instruments: host spans around the port's layer entry
points, installed from here at run time, and a ``torch.profiler``
sub-window of a few steady batches read back from its Chrome trace.

Spans: ``Pipeline.sample_inputs``, ``Pipeline.sample_sequence_inputs``,
``Pipeline.render``, ``BatchStep.forward_backward``, ``BatchStep.update``
and the data-parallel ``ShardedBatchStep.forward_backward`` (under the same
name, ``forward_backward``; only a cell of several cards builds one) are
wrapped so that each call adds its host time to a total and, under the
profiler, opens a ``record_function`` range of the same name, which the
idle gaps of ``breakdown`` are labelled by. Nothing of the port is edited.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

from .session import ROOT

SPANS = (("parallel.pipeline", "Pipeline", "sample_inputs"),
         ("parallel.pipeline", "Pipeline", "sample_sequence_inputs"),
         ("parallel.pipeline", "Pipeline", "render"),
         ("train.loop", "BatchStep", "forward_backward"),
         ("train.loop", "BatchStep", "update"),
         ("train.loop", "ShardedBatchStep", "forward_backward"))
PACKAGE = "constructionsceneposeestimation_tpu_torch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"
BATCH = "perfbench.batch"


class Spans:
    """Host time by span name, summed over every call while installed."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self._undo = []

    def _wrap(self, name, fn):
        spans = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                try:
                    return fn(*args, **kwargs)
                finally:
                    spans.seconds[name] += time.perf_counter() - t0
                    spans.calls[name] += 1

        return wrapped

    def install(self):
        import importlib

        for mod_name, cls_name, meth in SPANS:
            cls = getattr(importlib.import_module(f"{PACKAGE}.{mod_name}"), cls_name)
            fn = cls.__dict__[meth]
            setattr(cls, meth, self._wrap(meth, fn))
            self._undo.append((cls, meth, fn))
        return self

    def remove(self):
        for cls, meth, fn in reversed(self._undo):
            setattr(cls, meth, fn)
        self._undo.clear()


def handwritten_kernels(root: Path = ROOT) -> frozenset[str]:
    """The names of the port's hand-written CUDA kernels, read from its
    sources (``csrc/*.cu``)."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(", re.S)
    names = set()
    for f in sorted((root / PACKAGE / "csrc").glob("*.cu")):
        names.update(pat.findall(f.read_text()))
    return frozenset(names)


def base_name(kernel: str) -> str:
    """A kernel's own name without its return type, namespaces, template
    arguments or parameters: ``void cspe::(anonymous
    namespace)::rgb_kernel<false, 0>(float const*)`` -> ``rgb_kernel``."""
    head = re.sub(r"\(anonymous namespace\)", "", kernel)
    head = head.split("(", 1)[0].split("<", 1)[0].split()
    return head[-1].split("::")[-1] if head else kernel


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The profiled sub-window of ``batches`` batches or steps, from the
    profiler's Chrome trace (times in microseconds), with the host spans of
    the whole measured window beside it."""

    def __init__(self, events: list, batches: int, spans: Spans, window_batches: int,
                 handwritten: frozenset, extras: dict | None = None):
        self.batches, self.window_batches = batches, window_batches
        self.spans, self.handwritten = spans, handwritten
        self.extras = dict(extras or {})
        x = [e for e in events if e.get("ph") == "X"]
        win = [e for e in x if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if not win:
            raise ValueError("the trace holds no window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        inside = lambda e: self.t0 <= float(e["ts"]) <= self.t1
        self.device = [e for e in x if e.get("cat") in DEVICE_CATS and inside(e)]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.runtime = [e for e in x if e.get("cat") == "cuda_runtime" and inside(e)]
        self.annotations = [e for e in x if e.get("cat") == "user_annotation"
                            and e["name"] != WINDOW and inside(e)]
        self.busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def is_handwritten(self, e) -> bool:
        return base_name(e["name"]) in self.handwritten

    def device_ms(self, events) -> float:
        return sum(float(e["dur"]) for e in events) * 1e-3

    def _open(self, names):
        """A test of whether a host time lies inside a span of ``names``."""
        spans = [(float(a["ts"]), float(a["ts"]) + float(a["dur"]))
                 for a in self.annotations if a["name"] in names]
        return lambda t: any(a <= t <= b for a, b in spans)

    def under(self, names, events=None) -> list:
        """The device activities (the kernels where ``events`` is None)
        issued while a span of ``names`` was open: the runtime call that
        issued it (matched by correlation id) lies inside the span in time,
        on any thread (autograd's backward launches from its own)."""
        inside = self._open(names)
        launch = {e["args"].get("correlation"): e for e in self.runtime if "args" in e}
        out = []
        for k in self.kernels if events is None else events:
            r = launch.get(k.get("args", {}).get("correlation"))
            if r is not None and inside(float(r["ts"])):
                out.append(k)
        return out

    def syncs(self, names=(BATCH,)) -> int:
        """Runtime calls in which the host waits on the device, made while a
        span of ``names`` was open: the batches', not the window's closing
        synchronise."""
        inside = self._open(names)
        return sum(1 for e in self.runtime
                   if ("Synchronize" in e["name"] or e["name"] == "cudaMemcpy")
                   and inside(float(e["ts"])))

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with no device work."""
        gaps, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def label(self, t: float) -> str:
        """The innermost span open on the host at time ``t``."""
        best = None
        for a in self.annotations:
            s, d = float(a["ts"]), float(a["dur"])
            if s <= t <= s + d and (best is None or d < best[1]):
                best = (a["name"], d)
        return best[0] if best else "harness"

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for e in self.device:
            by_op[e["name"][:120]] += float(e["dur"]) * 1e-6
        by_gap = defaultdict(float)
        for a, b in self.idle_gaps():
            by_gap[f"idle during {self.label(0.5 * (a + b))}"] += (b - a) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


@contextlib.contextmanager
def profiled(device):
    """A ``torch.profiler`` over the block, yielding a holder whose
    ``events`` are the Chrome trace's after the block; the block runs
    inside the window annotation and ends with a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Held", (), {"events": []})()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder.events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
