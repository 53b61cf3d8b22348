"""Share of the profiled sub-window, in %, in which no kernel or copy ran on
the device. An upper bound: the profiler slows the host. Nothing where the
trace holds no device activity."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace.device else None
