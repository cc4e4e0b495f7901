"""Compositing: the self time of the stage ``compositing`` (warp, exposure,
gain; its ``graph_cut`` child taken out) plus ``render_preview``,
seconds per stitch request."""


def read(ctx):
    n = ctx.counts.get("stitch")
    if not n:
        return None
    s = ctx.stage_s
    return (s["compositing"] - s["graph_cut"] + s["render_preview"]) / n
