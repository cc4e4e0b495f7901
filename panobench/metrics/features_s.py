"""Decode and features: the stages ``load`` and ``keypoints``, seconds
per stitch request (traced run, stages drained at their boundaries)."""


def read(ctx):
    n = ctx.counts.get("stitch")
    if not n:
        return None
    s = ctx.stage_s
    return (s["load"] + s["keypoints"]) / n
