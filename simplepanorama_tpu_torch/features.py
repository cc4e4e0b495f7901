"""Feature-extraction front end: batch images onto the device, run SIFT,
return center-origin keypoints + rootSIFT descriptors.

Port of the list path of simplepanorama_tpu/features.py
(img::images::calculate_keypoints of the reference). Every image is
edge-padded to the common max shape rounded to a multiple of 8 and goes
through ops.sift.extract_sift_batch in chunks of ``_SIFT_CHUNK`` images
(results are per image, so the chunking changes nothing but peak memory).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from simplepanorama_tpu_torch.config import Config
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


def extract_features(images: Sequence[np.ndarray], cfg: Config,
                     progress: Optional[Callable[[float], None]] = None,
                     cancelled: Optional[Callable[[], bool]] = None,
                     device="cpu") -> List[Features]:
    """SIFT features for a list of BGR uint8 images on ``device``."""
    if not images:
        return []
    if cancelled is not None and cancelled():
        raise RuntimeError("Process canceled")
    K = cfg.sift_max_features()
    Hp = (max(im.shape[0] for im in images) + 7) // 8 * 8
    Wp = (max(im.shape[1] for im in images) + 7) // 8 * 8
    n = len(images)
    batch = np.zeros((n, Hp, Wp, 3), np.uint8)
    hw = np.zeros((n, 2), np.int64)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        batch[i] = np.pad(im, ((0, Hp - h), (0, Wp - w), (0, 0)), mode="edge")
        hw[i] = (h, w)
    batch_d = torch.as_tensor(batch, device=device)
    hw_d = torch.as_tensor(hw, device=device)

    outs = []
    for s in range(0, n, _SIFT_CHUNK):
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        outs.append(extract_sift_batch(
            batch_d[s:s + _SIFT_CHUNK], hw_d[s:s + _SIFT_CHUNK], max_kp=K,
            n_layers=cfg.nOctaveLayers,
            contrast_thresh=float(cfg.contrastThreshold),
            edge_thresh=float(cfg.edgeThreshold),
            sigma=float(cfg.sigma_sift)))
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
