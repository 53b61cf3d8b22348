"""Device ms a training step in kernels launched under
``BatchStep.forward_backward`` and ``BatchStep.update`` (the augment,
forward, loss, backward and AdamW), in the profiled sub-window."""


def read(trace):
    ks = trace.under(("forward_backward", "update"))
    return trace.device_ms(ks) / trace.batches if ks else None
