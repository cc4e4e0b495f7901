"""Feature-extraction front end: batch images onto the device, run SIFT,
return center-origin keypoints + rootSIFT descriptors.

Port of simplepanorama_tpu/features.py (img::images::calculate_keypoints
of the reference). Every image is edge-padded to the common max shape
rounded to a multiple of 8 and goes through ops.sift.extract_sift_batch in
chunks sized to a memory budget (``_sift_chunk_size``; results are per
image, so the chunking changes nothing but peak memory). The images come
as a list, or as an io.PendingLoad still decoding (the streaming path of
run_pipeline). In a world of several ranks (parallel.mesh.pipeline_mesh)
each rank extracts its contiguous shard of the images (multihost.
host_shard) at the common pad and the feature tables are all-gathered,
as the JAX package's multi-process extraction does; the streaming decode
is single-process. A chunk that runs out of device memory is released
and split: the chunk size halves and the extraction goes on from that
chunk, and the size that ran is remembered per padded shape for the
process (``_SIFT_CHUNK_CACHE``), as the JAX package does on its
compile-time out-of-memory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from simplepanorama_tpu_torch.config import Config
from simplepanorama_tpu_torch.io import PendingLoad
from simplepanorama_tpu_torch.ops.sift import extract_sift_batch
from simplepanorama_tpu_torch.utils.device import checked_device, empty_cache

# (Hp, Wp, K, nOctaveLayers) -> the chunk size a run fell back to after
# running out of device memory at that padded shape
_SIFT_CHUNK_CACHE: dict = {}


def _shape_key(Hp: int, Wp: int, cfg: Config):
    return (Hp, Wp, cfg.sift_max_features(), cfg.nOctaveLayers)


def _sift_chunk_size(nb: int, Hp: int, Wp: int, cfg: Config,
                     step: int = 1) -> int:
    """Images per SIFT launch for ``nb`` images padded to (Hp, Wp): the
    JAX package's memory model, Hp * Wp * (nOctaveLayers + 3) * 550 bytes
    per image (the x2-upscaled pyramid and its refinement maps), against
    SPT_SIFT_MEM_BUDGET bytes (default 9 GB), at most 8 and at least 1,
    rounded down to a multiple of ``step`` (the ranks of a world, at
    least ``step``); no more than a size that ran out of memory left
    behind at this shape."""
    per_img = Hp * Wp * (cfg.nOctaveLayers + 3) * 550
    budget = int(os.environ.get("SPT_SIFT_MEM_BUDGET", 9_000_000_000))
    G = max(1, min(nb, 8, budget // max(1, per_img)))
    G = max(step, G // step * step)
    return min(G, _SIFT_CHUNK_CACHE.get(_shape_key(Hp, Wp, cfg), G))


def _halved(G: int, step: int, key) -> int:
    """The chunk size after ``G`` images ran out of device memory: half,
    a multiple of ``step`` and at least ``step``, remembered for the
    shape ``key``."""
    G = max(step, G // 2 // step * step)
    _SIFT_CHUNK_CACHE[key] = min(G, _SIFT_CHUNK_CACHE.get(key, G))
    return G


def _sift_or_none(batch, hw, cfg: Config, least: bool):
    """_sift on one chunk, or None when the device ran out of memory and
    the chunk can still be split (not ``least``); then the chunk's memory
    is released before this returns (the exception, and with it every
    tensor of the failed chunk, is gone by then). Any other error, and
    running out of memory at the least chunk, raises."""
    try:
        return _sift(batch, hw, cfg)
    except torch.OutOfMemoryError:
        if least:
            raise
    empty_cache()
    return None


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
                     device="cuda") -> List[Features]:
    """SIFT features on ``device`` for a list of BGR uint8 images, or for
    an io.PendingLoad whose images are still decoding: then each chunk of
    images goes to SIFT as soon as it has decoded, and the load is
    finalized (the ImageSet filled in order) before this returns.
    ``cancelled`` is polled between chunks. ``device`` is the card unless
    the caller asks for another."""
    device = checked_device(device)
    from simplepanorama_tpu_torch.parallel.mesh import pipeline_mesh
    pending = images if isinstance(images, PendingLoad) else None
    mesh = pipeline_mesh()
    if pending is not None and (mesh is not None
                                or any(d is None for d in pending.dims)):
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
    elif mesh is not None:
        outs, hw_d, batch_d = _extract_sharded(images, cfg, cancelled,
                                               device, mesh)
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
                  device, pad_dims=None, step: int = 1):
    """Every image padded (to the largest of ``pad_dims``, by default of
    the images) and uploaded at once, SIFT in chunks of
    ``_sift_chunk_size`` (a multiple of ``step``), halved when a chunk
    runs out of device memory. Returns (per-chunk SIFT outputs, hw,
    batch)."""
    n = len(images)
    Hp, Wp = _pad8(pad_dims or [im.shape[:2] for im in images])
    batch = np.zeros((n, Hp, Wp, 3), np.uint8)
    for i, im in enumerate(images):
        batch[i] = _pad_edge(im, Hp, Wp)
    batch_d = torch.as_tensor(batch, device=device)
    hw_d = torch.as_tensor([im.shape[:2] for im in images], dtype=torch.int64,
                           device=device)
    G = _sift_chunk_size(n, Hp, Wp, cfg, step)
    outs = []
    s = 0
    while s < n:
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        out = _sift_or_none(batch_d[s:s + G], hw_d[s:s + G], cfg,
                            G <= step)
        if out is None:
            G = _halved(G, step, _shape_key(Hp, Wp, cfg))
            continue
        outs.append(out)
        s += G
    return outs, hw_d, batch_d


def _extract_sharded(images: Sequence[np.ndarray], cfg: Config, cancelled,
                     device, mesh):
    """This rank's contiguous shard of the images (multihost.host_shard),
    padded with 8x8 blanks to ceil(n / ranks) so that every rank runs the
    same shapes, extracted at the common pad of all the images; then one
    all_gather per table. Returns (the gathered outputs as one chunk, hw
    of every image, None: the pixels stay with their ranks)."""
    from simplepanorama_tpu_torch.parallel.mesh import all_gather_cat
    from simplepanorama_tpu_torch.parallel.multihost import host_shard
    n = len(images)
    per = (n + mesh.size - 1) // mesh.size
    local = [images[i] for i in host_shard(list(range(n)), mesh.size,
                                             mesh.rank)]
    local += [np.zeros((8, 8, 3), np.uint8)] * (per - len(local))
    outs, _, _ = _extract_list(local, cfg, cancelled, device,
                               pad_dims=[im.shape[:2] for im in images],
                               step=mesh.size)
    tables = (torch.cat(parts) for parts in zip(*outs))
    gathered = [all_gather_cat(t, mesh)[:n] for t in tables]
    hw_d = torch.as_tensor([im.shape[:2] for im in images],
                           dtype=torch.int64, device=device)
    return [gathered], hw_d, None


def _extract_stream(pending: PendingLoad, cfg: Config, cancelled, device):
    """Streaming extraction (the JAX package's _extract_arrays_stream):
    chunk by chunk in image order, wait for the chunk's decodes, pad,
    upload into its rows of the device batch and queue its SIFT, so the
    decode pool works on later images while the device works on earlier
    ones. A chunk holds ``_sift_chunk_size`` images, and with 6 or more
    images at most (n + 2) // 3, so the first SIFT starts after a third of
    the decodes; a chunk that runs out of device memory halves the size
    and goes again from its first image (its rows stay uploaded). A
    decode that failed raises here. Returns (per-chunk SIFT outputs, hw,
    batch)."""
    n = len(pending)
    Hp, Wp = _pad8(pending.dims)
    G = _sift_chunk_size(n, Hp, Wp, cfg)
    if n >= 6:
        G = min(G, (n + 2) // 3)
    batch_d = torch.empty((n, Hp, Wp, 3), dtype=torch.uint8, device=device)
    hw_d = torch.as_tensor(pending.dims, dtype=torch.int64, device=device)
    outs = []
    s = uploaded = 0
    while s < n:
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        end = min(s + G, n)
        if end > uploaded:
            ids = range(uploaded, end)
            blk = np.zeros((len(ids), Hp, Wp, 3), np.uint8)
            for k, i in enumerate(ids):
                im = pending.get(i)
                if tuple(im.shape[:2]) != tuple(pending.dims[i]):
                    raise RuntimeError(
                        f"{pending.todo[i]} decoded to {im.shape[:2]}, its "
                        f"header says {pending.dims[i]}")
                blk[k] = _pad_edge(im, Hp, Wp)
            batch_d[uploaded:end] = torch.as_tensor(blk, device=device)
            uploaded = end
        out = _sift_or_none(batch_d[s:end], hw_d[s:end], cfg, G <= 1)
        if out is None:
            G = _halved(G, 1, _shape_key(Hp, Wp, cfg))
            continue
        outs.append(out)
        s = end
    return outs, hw_d, batch_d
