"""The hand-written kernels' share of their roofline, in %: the sum of the
bounds of the first profiled batch's kernel calls (``harness/roofline.py``:
the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s, counted
from the call's inputs and the work they need) over their device ms a batch
in the profiled sub-window. Nothing where a kernel ran that has no count."""


def read(trace):
    bound = trace.extras.get("kernel_bound_ms")
    ks = [k for k in trace.kernels if trace.is_handwritten(k)]
    if bound is None or not ks:
        return None
    return 100.0 * bound / (trace.device_ms(ks) / trace.batches)
