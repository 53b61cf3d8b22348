"""Device ms a generated batch in the port's hand-written kernels (those
defined in its ``csrc/*.cu``), in the profiled sub-window."""


def read(trace):
    ks = [k for k in trace.kernels if trace.is_handwritten(k)]
    return trace.device_ms(ks) / trace.batches if ks else None
