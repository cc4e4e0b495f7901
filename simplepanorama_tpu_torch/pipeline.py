"""Pipeline entry point: the `Panorama` class.

Port of simplepanorama_tpu/pipeline.py (the reference's headless path,
pan::panorama): construct with image paths and a device, `stitch(config)`,
then `get_preview()` and `get_panorama()`; `save_state()` and
`Panorama.from_state()` checkpoint the post-BA state and resume from it;
`diagnose()` returns the tables of the stages before BA.
Progress is reported through a callback and cancellation through a token
polled at stage boundaries. After a stitch (or a set_config with a new
result) a background thread decodes the full-res connected images and
uploads their packed source stack while the preview composites;
`get_panorama()` joins it and renders from the stack on the device (from
the decoded images through the chunked route when the upload ran out of
device memory).

The device is explicit: ``device="cuda"`` runs on the GPU and raises when
no GPU is present; the CPU is used only when asked for. The entry points
turn off TF32 for float32 matmuls and cuDNN convolutions, so the SIFT,
exposure and blending convolutions keep full float32 precision.
"""

from __future__ import annotations

import atexit
import contextlib
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from simplepanorama_tpu_torch.config import Config
from simplepanorama_tpu_torch.utils.device import (  # noqa: F401
    checked_device as _checked_device, full_precision)


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


# the prefetch threads still running, each with its cancel event
_PREFETCHES: set = set()


def _join_prefetches() -> None:
    """At exit, before the interpreter finalizes: cancel the prefetches
    still running and wait for their threads. A daemon thread that is
    inside a torch call when the interpreter finalizes aborts the process
    ("terminate called without an active exception"), as a command that
    stitches and exits without get_panorama() would leave its prefetch."""
    for thread, cancel in list(_PREFETCHES):
        cancel.set()
        thread.join()


atexit.register(_join_prefetches)


class Panorama:
    """Full pipeline entry point. See `stitch()`."""

    def __init__(self, paths: Sequence[str],
                 progress: Optional[Callable[[float, str], None]] = None,
                 device="cuda"):
        from simplepanorama_tpu_torch.io import ImageSet
        self.device = _checked_device(device)
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
        # (params, thread, result dict, cancel event) of the background
        # full-res prefetch; see _start_full_prefetch
        self._full_prefetch = None
        # what the last get_panorama took from the prefetch: the thread's
        # decode_s and upload_s, and join_wait_s, the wait at the join
        self.prefetch_stats: dict = {}

    def cancel(self) -> None:
        self.cancel_token.cancel()

    def _stop_full_prefetch(self) -> None:
        """Cancel the in-flight prefetch, if any, and wait for its thread."""
        if self._full_prefetch is not None:
            _, thread, _, cancel = self._full_prefetch
            cancel.set()
            thread.join()
            self._full_prefetch = None

    def _start_full_prefetch(self) -> None:
        """Decode the full-res connected images and upload their packed
        source stack (render.fullres.prefetch_sources) in a background
        thread, while the preview composites; get_panorama joins it. The
        sources depend only on the stitch result, never on the
        compositing config. A stale prefetch is cancelled and joined
        first, so two never run at once. The thread makes its CUDA calls
        under this Panorama's device.

        An upload that runs out of device memory drops its partial stack
        and keeps the decoded images (``upload_oom``): get_panorama renders
        them through the chunked route on the same card, as the JAX
        package's thread falls back to the synchronous path. Unlike the
        JAX package, which falls back on any error and decodes again, a
        failed decode is kept and raised by get_panorama; a cancelled
        prefetch is not an error."""
        import torch
        from simplepanorama_tpu_torch.render.fullres import prefetch_sources
        from simplepanorama_tpu_torch.utils.device import empty_cache
        params, images, dev = self.stitch_params, self.images, self.device
        if params is None:
            return
        self._stop_full_prefetch()
        res = params.res
        connected = [False] * len(images.loaded)
        for g in res.nodes:
            connected[g] = True
        threads = self.config.threads if self.config else 4
        out: dict = {}
        cancel = threading.Event()

        def work():
            try:
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    full = images.load_connected_images(connected, threads)
                    out["decode_s"] = time.perf_counter() - t0
                    if cancel.is_set():
                        return
                    comp_full = [full[g] for g in res.nodes]
                    out["full"] = comp_full
                    if cancel.is_set():
                        return
                    t0 = time.perf_counter()
                    try:
                        out["stack"] = prefetch_sources(params, comp_full)
                    except torch.OutOfMemoryError:
                        out["upload_oom"] = True
                    out["upload_s"] = time.perf_counter() - t0
                    if out.get("upload_oom") and dev.type == "cuda":
                        # the partial stack's blocks, for the render
                        empty_cache()
            except Exception as e:      # raised again by get_panorama
                out["error"] = e
            finally:
                _PREFETCHES.discard(running)

        thread = threading.Thread(target=work, daemon=True)
        running = (thread, cancel)
        _PREFETCHES.add(running)
        thread.start()
        self._full_prefetch = (params, thread, out, cancel)

    def stitch(self, config: Optional[Config] = None) -> "Panorama":
        from simplepanorama_tpu_torch import stitcher
        # the prefetch in flight is for the result this stitch replaces:
        # its decode and its stack would compete with the stitch for the
        # host and the card (a capture of the BA would not fail by it:
        # ba.LMProgram captures thread-local)
        self._stop_full_prefetch()
        self.config = config or Config()
        self.result, self.stitch_params, self.connected = \
            stitcher.run_pipeline(self.images, self.config, self.progress,
                                  self.cancel_token, device=self.device,
                                  pair_draws=self.pair_draws)
        self._full_pano = None
        self._start_full_prefetch()
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
        if self._full_prefetch is None or \
                self._full_prefetch[0].res is not self.result:
            self._start_full_prefetch()
        return self

    def get_preview(self) -> np.ndarray:
        from simplepanorama_tpu_torch import stitcher
        if self.stitch_params is None:
            raise RuntimeError("stitch() has not been run")
        return stitcher.render_preview(self.stitch_params, self.config)

    def get_panorama(self, roi=None) -> np.ndarray:
        """Full-resolution render (re-projects and re-blends only: BA ran
        at init_size; _panorama.cpp:259-354), cached until the next
        stitch() or set_config(). It joins the background prefetch of this
        result and renders from its source stack (raising the prefetch's
        decode error, if it had one; after an upload that ran out of
        memory, from its decoded images through the chunked route), or
        decodes the images itself when there is none. ``roi`` is (x, y, w, h) in preview coordinates, rescaled
        like _panorama.cpp:547-569."""
        from simplepanorama_tpu_torch import stitcher
        if self.stitch_params is None:
            raise RuntimeError("stitch() has not been run")
        if self._full_pano is None:
            pre = self._full_prefetch
            if pre is not None and pre[0].res is self.stitch_params.res:
                _, thread, out, _ = pre
                t0 = time.perf_counter()
                thread.join()
                self.prefetch_stats = {
                    "decode_s": out.get("decode_s"),
                    "upload_s": out.get("upload_s"),
                    "upload_oom": out.get("upload_oom", False),
                    "join_wait_s": time.perf_counter() - t0}
                # the render takes the images and the stack; once it has
                # them, the cached panorama serves later calls
                self._full_prefetch = None
                if "error" in out:
                    raise out["error"]
                self._full_pano = stitcher.render_full(
                    self.stitch_params, self.config, out["full"],
                    src_stack=out.get("stack"))
                out.clear()
            else:
                self.prefetch_stats = {}
                self._full_pano = stitcher.render_full_from_imageset(
                    self.stitch_params, self.config, self.images)
        if roi is None:
            return self._full_pano
        # the preview's shape is its canvas
        return crop_roi(self._full_pano, self.stitch_params.state.canvas_hw,
                        roi)

    def save_state(self, path) -> None:
        """Checkpoint the post-BA stitch state (rot/K/adjacency/order) so
        compositing can later resume, with any blend/projection/seam
        settings, without features, matching or BA."""
        from simplepanorama_tpu_torch.utils.checkpoint import \
            save_stitch_state
        if self.result is None:
            raise RuntimeError("stitch() has not been run")
        save_stitch_state(path, self.result, paths=self.images.loaded)

    @classmethod
    def from_state(cls, path, paths: Optional[Sequence[str]] = None,
                   config: Optional[Config] = None,
                   progress: Optional[Callable[[float, str], None]] = None,
                   device="cuda") -> "Panorama":
        """Resume from a checkpoint written by save_state (by either
        package): reload the images at init_size, rebuild the compositing
        state under ``config`` on ``device``, and return a Panorama ready
        for get_preview() / get_panorama(). ``paths`` overrides the image
        list recorded in the checkpoint (same order as at save time;
        res.nodes indexes into it)."""
        from simplepanorama_tpu_torch.utils.checkpoint import \
            load_stitch_state
        res, saved_paths = load_stitch_state(path, with_paths=True)
        if paths is None:
            paths = saved_paths
        if not paths:
            raise RuntimeError("checkpoint has no image list; pass paths=")
        p = cls(paths, progress, device=device)
        p.result = res
        p.set_config(config or Config())
        return p


def diagnose(paths, config: Optional[Config] = None, device="cuda") -> dict:
    """Single-threaded inspection run on ``device`` (panorama::test,
    _panorama.cpp:572-609): load -> keypoints -> match -> adjacency,
    returning the intermediate tables for debugging."""
    from simplepanorama_tpu_torch.adjacency import build_adjacency
    from simplepanorama_tpu_torch.features import extract_features
    from simplepanorama_tpu_torch.geometry.focal import focal_from_hom
    from simplepanorama_tpu_torch.geometry.graph import connected_components
    from simplepanorama_tpu_torch.io import ImageSet
    device = _checked_device(device)
    cfg = config or Config()
    images = ImageSet(paths)
    images.load_resized(cfg.init_size, threads=1)
    feats = extract_features(images.img_data, cfg, device=device)
    sizes = [im.shape[:2] for im in images.img_data]
    adjres = build_adjacency(feats, sizes, cfg)
    comps = connected_components(adjres.adj)
    return {
        "n_images": len(images.img_data),
        "keypoint_counts": [f.count for f in feats],
        "raw_match_counts": adjres.raw_counts,
        "adjacency": adjres.adj,
        "hom_mat": adjres.hom_mat,
        "components": [c.nodes for c in comps],
        "focal_estimate": focal_from_hom(adjres.hom_mat, adjres.adj),
    }
