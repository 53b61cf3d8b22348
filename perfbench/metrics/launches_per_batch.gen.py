"""Kernel launches and copies on the device a generated batch, in the
profiled sub-window (kernels, memcpy and memset activities) issued inside a
batch; nothing where the trace holds no device activity."""

from harness.tracing import BATCH


def read(trace):
    return len(trace.under((BATCH,), trace.device)) / trace.batches if trace.device else None
