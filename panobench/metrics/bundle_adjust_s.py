"""The BA: the stage ``bundle_adjust``, seconds per stitch request."""


def read(ctx):
    n = ctx.counts.get("stitch")
    if not n:
        return None
    s = ctx.stage_s
    return (s["bundle_adjust"]) / n
