"""Full-res: the stage ``render_full``, seconds per export request."""


def read(ctx):
    n = ctx.counts.get("export")
    if not n:
        return None
    s = ctx.stage_s
    return (s["render_full"]) / n
