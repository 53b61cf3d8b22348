"""Frames completed in the measured window over the window, by the same CUDA
events as the end-to-end ``frames_per_s``, in cells where that rate spreads
too widely from run to run to hold a bound and ``batch_ms_p95`` is the
end-to-end metric; nothing where the run kept no window."""


def read(trace):
    return trace.extras.get("window_frames_per_s")
