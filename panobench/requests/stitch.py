"""A stitch request: a new ``Panorama`` on the set's files, ``stitch``
under the cell's config, then ``get_preview`` (what a user waits for
from pressing stitch to seeing the preview; decoding is inside)."""


def run(req) -> None:
    from simplepanorama_tpu_torch import Panorama
    req.pano = Panorama(req.views.paths, device=req.device)
    req.pano.stitch(req.config)
    req.preview = req.pano.get_preview()
