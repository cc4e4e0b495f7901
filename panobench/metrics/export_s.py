"""Window seconds spent in ``get_panorama()`` calls, divided by the
exports completed."""


def read(ctx):
    w = ctx.walls.get("export")
    return sum(w) / len(w) if w else None
