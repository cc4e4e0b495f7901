"""Share of the traced stitch requests' time in which no operation runs
on the card, from the profiler's timeline, %."""


def read(ctx):
    if ctx.trace is None:
        return None
    spans = [(a, b) for k, a, b in ctx.trace.requests if k == "stitch"]
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_in(spans) / total)
