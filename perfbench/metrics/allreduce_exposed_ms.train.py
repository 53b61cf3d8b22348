"""Rank 0's device ms a training step in NCCL kernels (the gradient
all-reduce of DDP and the step's small reductions) during which no other
kernel ran, in the profiled sub-window: the exchange between the cards that
the step's compute does not hide, waits for a slower rank included.
Nothing where the trace holds no NCCL kernel (a one-card step)."""


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(trace):
    span = lambda k: (float(k["ts"]), float(k["ts"]) + float(k["dur"]))
    nccl = [span(k) for k in trace.kernels if "nccl" in k["name"].lower()]
    if not nccl:
        return None
    other = _union(span(k) for k in trace.kernels if "nccl" not in k["name"].lower())
    exposed = 0.0
    for a, b in _union(nccl):
        exposed += (b - a) - sum(max(0.0, min(b, d) - max(a, c)) for c, d in other)
    return exposed * 1e-3 / trace.batches
