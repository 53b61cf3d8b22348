"""The share of a generated batch's draws made on the card, in %: the port's
``gen.sample.draws.replay`` spans (the replay kernel's launch) over its
``gen.sample.draws`` spans in the profiled sub-window, times 100. Nothing
where the program opens no replay span (draws on the host alone)."""


def read(trace):
    names = [a["name"] for a in trace.annotations]
    replayed, draws = names.count("gen.sample.draws.replay"), names.count("gen.sample.draws")
    if not replayed or not draws:
        return None
    return 100.0 * replayed / draws
