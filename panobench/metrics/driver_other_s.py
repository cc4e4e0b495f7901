"""Entry and driver: the stitch requests' walls less the stages the other
stage metrics read, seconds per stitch request (``Panorama``,
``stitcher.run_pipeline`` between its stages, the host's waits)."""

STAGES = ("load", "keypoints", "matching", "bundle_adjust", "compositing",
          "render_preview")


def read(ctx):
    w = ctx.walls.get("stitch")
    if not w:
        return None
    return (sum(w) - sum(ctx.stage_s[k] for k in STAGES)) / len(w)
