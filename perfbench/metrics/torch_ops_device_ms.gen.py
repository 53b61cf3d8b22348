"""Device ms a generated batch in kernels that are not the port's
hand-written ones (PyTorch's own ops), in the profiled sub-window."""


def read(trace):
    ks = [k for k in trace.kernels if not trace.is_handwritten(k)]
    return trace.device_ms(ks) / trace.batches if ks else None
