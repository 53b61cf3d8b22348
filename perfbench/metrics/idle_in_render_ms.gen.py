"""Idle device ms a generated batch, in the profiled sub-window, in gaps
whose innermost open span is the port's ``gen.render`` or one of its stages
(``gen.render.world``, ``.sweep``, ``.rgb``, ``.labels``, ``.keypoints``,
``.heatmaps``): the card waiting while the host issues the render. Nothing
where the program opens no such span."""

from harness.stages import idle_ms


def read(trace):
    return idle_ms(trace, "gen.render")
