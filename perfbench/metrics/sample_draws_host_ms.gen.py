"""Host ms a generated batch in the port's ``gen.sample.draws`` span, in the
profiled sub-window: the CPU generators' draws for the scene groups, frames
or clips, up to the stacked host dict. Nothing where the program opens no
such span."""

from harness.stages import host_ms


def read(trace):
    return host_ms(trace, "gen.sample.draws")
