"""Feature-extraction front end: batch images onto the device, run SIFT,
return center-origin keypoints + rootSIFT descriptors.

Port of simplepanorama_tpu/features.py (img::images::calculate_keypoints
of the reference). Every image is edge-padded to the common max shape
rounded to a multiple of 8 and goes through ops.sift.extract_sift_batch in
chunks of at most ``_SIFT_CHUNK`` images (results are per image, so the
chunking changes nothing but peak memory). The images come as a list, or
as an io.PendingLoad still decoding (the streaming path of run_pipeline).
Not ported: the JAX package's chunk self-tuning on compile-time OOM and
its multi-process extraction.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from simplepanorama_tpu_torch.config import Config
from simplepanorama_tpu_torch.io import PendingLoad
from simplepanorama_tpu_torch.ops.sift import extract_sift_batch

# images per SIFT launch: bounds the dense refinement maps (~40 planes of
# the x2-upscaled octave-0 stack per image)
_SIFT_CHUNK = 4


@dataclasses.dataclass
class Features:
    """Per-image fixed-capacity features (host numpy)."""
    xy: np.ndarray        # (K, 2) float32, center-origin (x, y)
    size: np.ndarray      # (K,)
    response: np.ndarray  # (K,)
    desc: np.ndarray      # (K, 128) rootSIFT
    valid: np.ndarray     # (K,) bool

    @property
    def count(self) -> int:
        return int(np.asarray(self.valid).sum())


class FeatureSet(list):
    """List of per-image Features plus the stacked device tables the
    matching stage reads, and the padded uint8 image batch the warp stage
    samples (so pixels are uploaded once per stitch)."""
    device_batch = None   # (xy, desc, valid) tensors, center-origin
    device_images = None  # (N, Hp, Wp, 3) uint8, row i = image i


def extract_features(images, cfg: Config,
                     progress: Optional[Callable[[float], None]] = None,
                     cancelled: Optional[Callable[[], bool]] = None,
                     device="cpu") -> List[Features]:
    """SIFT features on ``device`` for a list of BGR uint8 images, or for
    an io.PendingLoad whose images are still decoding: then each chunk of
    images goes to SIFT as soon as it has decoded, and the load is
    finalized (the ImageSet filled in order) before this returns.
    ``cancelled`` is polled between chunks."""
    pending = images if isinstance(images, PendingLoad) else None
    # (the JAX package also takes the list for multi-process extraction;
    # the port runs one device)
    if pending is not None and any(d is None for d in pending.dims):
        # a header the probe could not read: every decode first
        images = pending.finalize()
        pending = None
    if pending is None and not images:
        return []
    if cancelled is not None and cancelled():
        raise RuntimeError("Process canceled")
    if pending is not None:
        outs, hw_d, batch_d = _extract_stream(pending, cfg, cancelled,
                                              device)
        pending.finalize()
    else:
        outs, hw_d, batch_d = _extract_list(images, cfg, cancelled, device)
    n = hw_d.shape[0]
    xy, size, resp, desc, valid = (torch.cat(parts) for parts in zip(*outs))
    # center-origin shift with integer halves (``pt.x - img.cols / 2``),
    # invalid slots zeroed
    half = torch.stack([hw_d[:, 1] // 2, hw_d[:, 0] // 2], -1).to(torch.float32)
    xy = torch.where(valid[..., None], xy - half[:, None, :],
                     torch.zeros_like(xy))

    xy_h, size_h, resp_h, desc_h, valid_h = (
        t.cpu().numpy() for t in (xy, size, resp, desc, valid))
    out = FeatureSet()
    for i in range(n):
        out.append(Features(xy=xy_h[i], size=size_h[i], response=resp_h[i],
                            desc=desc_h[i], valid=valid_h[i]))
        if progress is not None:
            progress(1.0 / n)
    out.device_batch = (xy, desc, valid)
    out.device_images = batch_d
    return out


def _sift(batch, hw, cfg: Config):
    return extract_sift_batch(
        batch, hw, max_kp=cfg.sift_max_features(), n_layers=cfg.nOctaveLayers,
        contrast_thresh=float(cfg.contrastThreshold),
        edge_thresh=float(cfg.edgeThreshold), sigma=float(cfg.sigma_sift))


def _pad8(dims):
    return ((max(d[0] for d in dims) + 7) // 8 * 8,
            (max(d[1] for d in dims) + 7) // 8 * 8)


def _pad_edge(im: np.ndarray, Hp: int, Wp: int) -> np.ndarray:
    h, w = im.shape[:2]
    return np.pad(im, ((0, Hp - h), (0, Wp - w), (0, 0)), mode="edge")


def _extract_list(images: Sequence[np.ndarray], cfg: Config, cancelled,
                  device):
    """Every image padded and uploaded at once, SIFT in chunks of
    ``_SIFT_CHUNK``. Returns (per-chunk SIFT outputs, hw, batch)."""
    n = len(images)
    Hp, Wp = _pad8([im.shape[:2] for im in images])
    batch = np.zeros((n, Hp, Wp, 3), np.uint8)
    for i, im in enumerate(images):
        batch[i] = _pad_edge(im, Hp, Wp)
    batch_d = torch.as_tensor(batch, device=device)
    hw_d = torch.as_tensor([im.shape[:2] for im in images], dtype=torch.int64,
                           device=device)
    outs = []
    for s in range(0, n, _SIFT_CHUNK):
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        outs.append(_sift(batch_d[s:s + _SIFT_CHUNK], hw_d[s:s + _SIFT_CHUNK],
                          cfg))
    return outs, hw_d, batch_d


def _extract_stream(pending: PendingLoad, cfg: Config, cancelled, device):
    """Streaming extraction (the JAX package's _extract_arrays_stream):
    chunk by chunk in image order, wait for the chunk's decodes, pad,
    upload into its rows of the device batch and queue its SIFT, so the
    decode pool works on later images while the device works on earlier
    ones. With 6 or more images a chunk holds at most (n + 2) // 3 of
    them, so the first SIFT starts after a third of the decodes. A decode
    that failed raises here. Returns (per-chunk SIFT outputs, hw,
    batch)."""
    n = len(pending)
    Hp, Wp = _pad8(pending.dims)
    G = min(_SIFT_CHUNK, n)
    if n >= 6:
        G = min(G, (n + 2) // 3)
    batch_d = torch.empty((n, Hp, Wp, 3), dtype=torch.uint8, device=device)
    hw_d = torch.as_tensor(pending.dims, dtype=torch.int64, device=device)
    outs = []
    for s in range(0, n, G):
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        ids = range(s, min(s + G, n))
        blk = np.zeros((len(ids), Hp, Wp, 3), np.uint8)
        for k, i in enumerate(ids):
            im = pending.get(i)
            if tuple(im.shape[:2]) != tuple(pending.dims[i]):
                raise RuntimeError(
                    f"{pending.todo[i]} decoded to {im.shape[:2]}, its "
                    f"header says {pending.dims[i]}")
            blk[k] = _pad_edge(im, Hp, Wp)
        batch_d[s:s + len(ids)] = torch.as_tensor(blk, device=device)
        outs.append(_sift(batch_d[s:s + len(ids)], hw_d[s:s + len(ids)], cfg))
    return outs, hw_d, batch_d
