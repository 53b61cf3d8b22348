"""Device ms a training step in kernels launched inside the port's
``model.forward`` spans (the backbone's body and head, ``_Backbone.forward``;
the backward launches after the span has closed), in the profiled
sub-window. Nothing where the program opens no such span."""


def read(trace):
    ks = trace.under(("model.forward",))
    return trace.device_ms(ks) / trace.batches if ks else None
