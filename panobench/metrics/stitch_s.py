"""Window seconds spent in stitch requests (``stitch`` then
``get_preview``), divided by the stitch requests completed."""


def read(ctx):
    w = ctx.walls.get("stitch")
    return sum(w) / len(w) if w else None
