"""Device ms a training step in kernels launched inside the port's
``model.exchange`` spans (HRNet's transitions and each module's fuse across
its branches, in the forward), in the profiled sub-window. Nothing where the
program opens no such span."""


def read(trace):
    ks = trace.under(("model.exchange",))
    return trace.device_ms(ks) / trace.batches if ks else None
