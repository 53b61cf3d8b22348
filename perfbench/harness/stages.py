"""The port's own spans in a traced run: ``gen.*`` and ``train.*``, opened
inside the program by ``utils/profiling.annotate`` and kept by the profiler
in the same trace as the kernels. A stage is a span with the spans nested
in it, whose names extend its own by a dot (``gen.sample`` holds
``gen.sample.draws``). Read from ``Trace`` alone; each function returns
None where the trace holds no span of the stage (a program without them).
"""

from __future__ import annotations


def _present(trace, span: str) -> bool:
    return any(a["name"] == span for a in trace.annotations)


def _within(name: str, span: str) -> bool:
    return name == span or name.startswith(span + ".")


def idle_ms(trace, span: str):
    """Idle device ms a batch in the gaps whose innermost open span, at the
    gap's middle, is ``span`` or one of its stages; None where the trace
    holds no device activity or no such span."""
    if not trace.device or not _present(trace, span):
        return None
    us = sum(b - a for a, b in trace.idle_gaps() if _within(trace.label(0.5 * (a + b)), span))
    return us * 1e-3 / trace.batches


def host_ms(trace, span: str):
    """Host ms a batch inside the spans named ``span``, summed."""
    if not _present(trace, span):
        return None
    return sum(float(a["dur"]) for a in trace.annotations if a["name"] == span) * 1e-3 \
        / trace.batches


def syncs(trace, span: str):
    """Host calls that wait on the device a batch, made while ``span`` was
    open (``Trace.syncs``); None where the trace holds no CUDA runtime call
    or no such span."""
    if not trace.runtime or not _present(trace, span):
        return None
    return trace.syncs((span,)) / trace.batches
