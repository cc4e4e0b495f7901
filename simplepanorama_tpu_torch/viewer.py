"""Interactive viewer state: zoom ladder + crop undo/redo.

Port of simplepanorama_tpu/viewer.py, a headless class with no device
code. The reference's GTK viewer toolbar keeps three pieces of interactive
state around the stitched preview (SURVEY §2.6):

  * a ZOOM LADDER: display widths [800, 1000, 1200, ..., full] in 200-px
    steps (built at src/ui/_image_viewer.cpp:429-461 of the reference),
    stepped by the zoom in/out buttons which re-render the cached
    preview at the new width (_viewer_toolbar.cpp:96-172);
  * a CROP STACK with undo/redo: a drawn rectangle is normalized
    (negative extents flipped), rescaled from display to preview
    coordinates, offset into and intersected with the CURRENT crop,
    then pushed — truncating any redo tail (return_rect,
    _viewer_toolbar.cpp:177-234); undo/redo walk the stack
    (_viewer_toolbar.cpp:277-303);
  * SAVE: full-resolution render of the current crop via
    panorama::get_panorama(crop) (save_img, _viewer_toolbar.cpp:238-273).

This module is that state machine as a headless library class, so any
front end (CLI, notebook, GUI) gets the reference viewer's exact
capability without GTK.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

Rect = Tuple[int, int, int, int]   # (x, y, w, h)


def zoom_ladder(width: int) -> List[int]:
    """Display-width ladder (open_progress_bar, _image_viewer.cpp:429-451):
    [800, 1000, ..., width] in 200-px steps; [800, width] when less than
    one full step above 800; empty (native display) when width <= 800."""
    if width <= 800:
        return []
    if width - 800 <= 200:
        return [800, width]
    zooms = int((width - 800) / 200)
    return [800 + 200 * i for i in range(zooms)] + [width]


def _intersect(a: Rect, b: Rect) -> Rect:
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    x0, y0 = max(ax, bx), max(ay, by)
    x1, y1 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
    return (x0, y0, max(0, x1 - x0), max(0, y1 - y0))


class PanoramaViewer:
    """Headless viewer state over a stitched ``Panorama`` (or any object
    with ``get_preview()``/``get_panorama(roi)``)."""

    def __init__(self, pano):
        self.pano = pano
        self.preview: np.ndarray = np.asarray(pano.get_preview())
        h, w = self.preview.shape[:2]
        self.crop_preview: Rect = (0, 0, w, h)
        # crop_vec[0] = full image; ret_counter indexes the current crop
        # (viewer_window_::crop_vec / ret_counter, _gtk_vars.h)
        self.crop_vec: List[Rect] = [self.crop_preview]
        self.ret_counter = 0
        self.zoom_val = zoom_ladder(w)
        # initial zoom: second rung when a ladder exists, else native
        # (_image_viewer.cpp:453-461)
        self.current_zoom = 1 if len(self.zoom_val) > 1 else -1

    # ---- zoom ladder (zin/zout, _viewer_toolbar.cpp:96-172) ----

    @property
    def display_width(self) -> int:
        if self.current_zoom < 0:
            return self.crop_preview[2]
        return self.zoom_val[self.current_zoom]

    def zoom_in(self) -> bool:
        if 0 <= self.current_zoom < len(self.zoom_val) - 1:
            self.current_zoom += 1
            return True
        return False

    def zoom_out(self) -> bool:
        if self.current_zoom > 0:
            self.current_zoom -= 1
            return True
        return False

    def display(self) -> np.ndarray:
        """The current crop of the preview resized to the zoom width
        (resizeKeepAspectRatio of the cropped preview)."""
        import cv2
        x, y, w, h = self.crop_preview
        img = self.preview[y:y + h, x:x + w]
        dw = self.display_width
        if dw == w:
            return img
        dh = max(1, int(round(h * dw / w)))
        return cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)

    # ---- crop stack (return_rect/undo/redo, _viewer_toolbar.cpp) ----

    def crop(self, rect: Rect, display_coords: bool = True) -> bool:
        """Apply a crop rectangle. ``display_coords=True`` treats the
        rect as drawn on ``display()`` (rescaled by the zoom ratio and
        offset into the current crop, return_rect :177-218); negative
        width/height are normalized like a backwards drag. Returns False
        (state unchanged) for an empty intersection."""
        x, y, w, h = rect
        if w < 0:
            x, w = x + w, -w
        if h < 0:
            y, h = y + h, -h
        if display_coords:
            ratio = self.crop_preview[2] / self.display_width
            x, y = int(x * ratio), int(y * ratio)
            w, h = int(w * ratio), int(h * ratio)
            x += self.crop_preview[0]
            y += self.crop_preview[1]
        ph, pw = self.preview.shape[:2]
        roi = _intersect((0, 0, pw, ph), (x, y, w, h))
        roi = _intersect(roi, self.crop_preview)
        if roi[2] * roi[3] <= 0:
            return False
        self.crop_preview = roi
        # truncate the redo tail, push, advance (:227-230)
        self.crop_vec = self.crop_vec[:self.ret_counter + 1]
        self.crop_vec.append(roi)
        self.ret_counter += 1
        return True

    def undo_crop(self) -> bool:
        if self.ret_counter > 0:
            self.ret_counter -= 1
            self.crop_preview = self.crop_vec[self.ret_counter]
            return True
        return False

    def redo_crop(self) -> bool:
        if self.ret_counter < len(self.crop_vec) - 1:
            self.ret_counter += 1
            self.crop_preview = self.crop_vec[self.ret_counter]
            return True
        return False

    # ---- save (save_img, _viewer_toolbar.cpp:238-273) ----

    def save(self, path: str, full_res: bool = True) -> bool:
        from simplepanorama_tpu_torch.io import save_image
        if full_res:
            out = self.pano.get_panorama(self.crop_preview)
        else:
            x, y, w, h = self.crop_preview
            out = self.preview[y:y + h, x:x + w]
        return save_image(path, out)
