"""Idle device ms a generated batch, in the profiled sub-window, in gaps
whose innermost open span is the port's ``gen.sample`` or one of its stages
(``gen.sample.draws``, ``.upload``, ``.scene``): the card waiting while the
host samples. Nothing where the program opens no such span."""

from harness.stages import idle_ms


def read(trace):
    return idle_ms(trace, "gen.sample")
