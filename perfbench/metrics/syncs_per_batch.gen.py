"""Host calls that wait on the device a generated batch, in the profiled
sub-window: CUDA runtime calls named ``*Synchronize`` and blocking
``cudaMemcpy`` made inside a batch (not the window's closing synchronise);
nothing where the trace holds no CUDA runtime call."""


def read(trace):
    return trace.syncs() / trace.batches if trace.runtime else None
