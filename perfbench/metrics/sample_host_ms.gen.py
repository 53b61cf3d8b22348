"""Host ms a batch inside the port's sampling call (``Pipeline.sample_inputs``
or ``sample_sequence_inputs``): all of its time over all of its calls in the
traced run, by the harness's span around it."""

NAMES = ("sample_inputs", "sample_sequence_inputs")


def read(trace):
    calls = sum(trace.spans.calls.get(n, 0) for n in NAMES)
    if not calls:
        return None
    return sum(trace.spans.seconds.get(n, 0.0) for n in NAMES) * 1e3 / calls
