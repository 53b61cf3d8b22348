"""Host calls that wait on the device a generated batch, in the profiled
sub-window, made inside the port's ``gen.render`` span: CUDA runtime calls
named ``*Synchronize`` and blocking ``cudaMemcpy``. Nothing where the trace
holds no CUDA runtime call or the program opens no such span."""

from harness.stages import syncs


def read(trace):
    return syncs(trace, "gen.render")
