"""An export request: ``get_panorama()`` of the panorama just stitched,
the full-resolution render (decoding included, whether it runs in the
call or in the prefetch thread the call joins)."""


def run(req) -> None:
    req.full = req.pano.get_panorama()
