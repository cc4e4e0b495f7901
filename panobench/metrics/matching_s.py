"""Matching: the stage ``matching``, seconds per stitch request."""


def read(ctx):
    n = ctx.counts.get("stitch")
    if not n:
        return None
    s = ctx.stage_s
    return (s["matching"]) / n
