"""Pipeline entry point: the `Panorama` class.

Port of simplepanorama_tpu/pipeline.py (the reference's headless path,
pan::panorama): construct with image paths and a device, `stitch(config)`,
then `get_preview()` and `get_panorama()`. Progress is reported through a
callback and cancellation through a token polled at stage boundaries. The
JAX package's background prefetch of the full-res sources is not ported.

The device is explicit: ``device="cuda"`` runs on the GPU and raises when
no GPU is present; the CPU is used only when asked for. The entry points
turn off TF32 for float32 matmuls and cuDNN convolutions, so the SIFT,
exposure and blending convolutions keep full float32 precision.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from simplepanorama_tpu_torch.config import Config
from simplepanorama_tpu_torch.stitcher import _not_ported


class StitchCancelled(RuntimeError):
    """Raised when the cancellation token is set mid-stitch."""


class CancelToken:
    """Cross-thread cancellation flag."""

    def __init__(self) -> None:
        self._ev = threading.Event()

    def cancel(self) -> None:
        self._ev.set()

    def cancelled(self) -> bool:
        return self._ev.is_set()

    def check(self) -> None:
        if self._ev.is_set():
            raise StitchCancelled("stitching cancelled")


class Progress:
    """Stage-weighted fractional progress (keypoints 1/6, matching 1/6,
    BA 1/3, seams 1/3)."""

    def __init__(self, callback: Optional[Callable[[float, str], None]] = None):
        self._cb = callback
        self.fraction = 0.0
        self.text = ""

    def add(self, delta: float, text: Optional[str] = None) -> None:
        self.fraction = min(1.0, self.fraction + delta)
        if text is not None:
            self.text = text
        if self._cb:
            self._cb(self.fraction, self.text)

    def set(self, value: float, text: Optional[str] = None) -> None:
        self.fraction = value
        if text is not None:
            self.text = text
        if self._cb:
            self._cb(self.fraction, self.text)


def full_precision() -> None:
    """Full float32 matmuls and convolutions (no TF32) on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def crop_roi(full: np.ndarray, preview_hw, roi) -> np.ndarray:
    """The full-res crop of ``roi`` = (x, y, w, h) given in preview
    coordinates: each edge scaled by the full/preview size ratio and
    truncated, then clipped to the panorama."""
    fh, fw = full.shape[:2]
    ph, pw = preview_hw
    sx, sy = fw / pw, fh / ph
    x, y, w, h = roi
    x0 = max(0, int(x * sx))
    y0 = max(0, int(y * sy))
    x1 = min(fw, int((x + w) * sx))
    y1 = min(fh, int((y + h) * sy))
    return full[y0:y1, x0:x1]


class Panorama:
    """Full pipeline entry point. See `stitch()`."""

    def __init__(self, paths: Sequence[str],
                 progress: Optional[Callable[[float, str], None]] = None,
                 device="cuda"):
        from simplepanorama_tpu_torch.io import ImageSet
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but no CUDA device "
                               "is available")
        full_precision()
        self.images = ImageSet(paths)
        self.progress = Progress(progress)
        self.cancel_token = CancelToken()
        self.result = None           # stitch_result equivalent
        self.stitch_params = None    # post-BA compositing state
        self.config: Optional[Config] = None
        self.connected = (0, 0)      # (n_connected, n_total)
        # RANSAC draw stream override (adjacency.build_adjacency)
        self.pair_draws = None
        self._full_pano: Optional[np.ndarray] = None

    def cancel(self) -> None:
        self.cancel_token.cancel()

    def stitch(self, config: Optional[Config] = None) -> "Panorama":
        from simplepanorama_tpu_torch import stitcher
        self.config = config or Config()
        self.result, self.stitch_params, self.connected = \
            stitcher.run_pipeline(self.images, self.config, self.progress,
                                  self.cancel_token, device=self.device,
                                  pair_draws=self.pair_draws)
        self._full_pano = None
        return self

    def set_config(self, config: Config) -> "Panorama":
        """Re-run compositing only against the existing BA result."""
        from simplepanorama_tpu_torch import stitcher
        if self.result is None:
            raise RuntimeError("no stitch state (run stitch())")
        self.config = config
        if not self.images.img_data:
            self.images.load_resized(config.init_size, config.threads)
        comp_imgs = [self.images.img_data[g] for g in self.result.nodes]
        self.stitch_params = stitcher.set_config(
            self.result, comp_imgs, config, device=self.device)
        self.connected = (len(self.result.nodes), len(self.images.img_data))
        self._full_pano = None
        return self

    def get_preview(self) -> np.ndarray:
        from simplepanorama_tpu_torch import stitcher
        if self.stitch_params is None:
            raise RuntimeError("stitch() has not been run")
        return stitcher.render_preview(self.stitch_params, self.config)

    def get_panorama(self, roi=None) -> np.ndarray:
        """Full-resolution render (re-projects and re-blends only: BA ran
        at init_size; _panorama.cpp:259-354), cached until the next
        stitch() or set_config(). ``roi`` is (x, y, w, h) in preview
        coordinates, rescaled like _panorama.cpp:547-569."""
        from simplepanorama_tpu_torch import stitcher
        if self.stitch_params is None:
            raise RuntimeError("stitch() has not been run")
        if self._full_pano is None:
            self._full_pano = stitcher.render_full_from_imageset(
                self.stitch_params, self.config, self.images)
        if roi is None:
            return self._full_pano
        # the preview's shape is its canvas
        return crop_roi(self._full_pano, self.stitch_params.state.canvas_hw,
                        roi)

    def save_state(self, path) -> None:
        raise _not_ported("save_state", "checkpoint")

    @classmethod
    def from_state(cls, path, paths=None, config=None, progress=None):
        raise _not_ported("from_state", "checkpoint")
