"""Blending: none / feathered (distance-transform alpha) / multiband.

Port of simplepanorama_tpu/render/blending.py (blnd::* of the reference)
on a device canvas. Per-image ROI blocks share one padded shape; the
canvas is margin-padded so every block lands by plain slicing. Bands are
blurred with zero padding at the block edge, like the JAX package. All
color math runs on the 0..255 scale.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simplepanorama_tpu_torch.ops.edt import distance_transform


def offs_list(offs) -> List[Tuple[int, int]]:
    """Block offsets as host ints: an (N, 2) tensor or a sequence of
    (y, x) pairs."""
    if torch.is_tensor(offs):
        offs = offs.tolist()
    return [(int(o[0]), int(o[1])) for o in offs]


def _acc_add(canvas, block, off):
    """canvas[y:y+Hb, x:x+Wb] += block, in place."""
    y, x = off
    canvas[y:y + block.shape[0], x:x + block.shape[1]] += block


def no_blend(imgs, msks, offs, canvas_hw):
    """Masked paste in order (blnd::no_blend)."""
    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    offs = offs_list(offs)
    canvas = torch.zeros((H + Hb, W + Wb, 3), dtype=torch.float32,
                         device=imgs.device)
    for i, (y, x) in enumerate(offs):
        sl = canvas[y:y + Hb, x:x + Wb]
        canvas[y:y + Hb, x:x + Wb] = torch.where(msks[i][..., None] > 0,
                                                 imgs[i], sl)
    return canvas[:H, :W]


def simple_blend(imgs, msks, offs, canvas_hw):
    """Feathering with normalized distance-transform alpha and (1 -
    accumulated alpha) compositing (blnd::simple_blend)."""
    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    offs = offs_list(offs)
    color = torch.zeros((H + Hb, W + Wb, 3), dtype=torch.float32,
                        device=imgs.device)
    alpha = torch.zeros((H + Hb, W + Wb), dtype=torch.float32,
                        device=imgs.device)
    for i, (y, x) in enumerate(offs):
        dt = distance_transform(msks[i] > 0)
        a = dt / torch.clamp(dt.max(), min=1e-12)
        acc_a = alpha[y:y + Hb, x:x + Wb]
        contrib_a = a * (1.0 - acc_a)
        _acc_add(color, imgs[i] * contrib_a[..., None], (y, x))
        alpha[y:y + Hb, x:x + Wb] = acc_a + contrib_a
    out = color[:H, :W] / torch.clamp(alpha[:H, :W, None], min=1e-12)
    return torch.where(alpha[:H, :W, None] > 0, out, torch.zeros_like(out))


def _gauss_taps(sigma: float, radius: int, device) -> torch.Tensor:
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(t * t) / (2.0 * sigma * sigma))
    return torch.as_tensor((k / k.sum()).astype(np.float32), device=device)


def _blur_fixed(x: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    """Separable Gaussian of one (H, W, C) image with a FIXED truncation
    radius (the reference sizes the kernel from the base sigma while
    blurring with the band sigma), zero padding."""
    return _blur_batch(x[None], sigma, radius)[0]


def _blur_batch(x: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    """_blur_fixed of a whole (N, H, W, C) batch: one grouped horizontal
    and one grouped vertical convolution over N*C channels."""
    k = _gauss_taps(sigma, radius, x.device)
    N, H, W, C = x.shape
    xx = x.permute(0, 3, 1, 2).reshape(1, N * C, H, W)
    xx = F.conv2d(xx, k.view(1, 1, 1, -1).expand(N * C, 1, 1, -1),
                  padding=(0, radius), groups=N * C)
    xx = F.conv2d(xx, k.view(1, 1, -1, 1).expand(N * C, 1, -1, 1),
                  padding=(radius, 0), groups=N * C)
    return xx.reshape(N, C, H, W).permute(0, 2, 3, 1)


def _band_sigmas(bands: int, sigma: float):
    return [float(np.sqrt(2 * (bands - i) + 1) * sigma) for i in range(bands)]


def mb_batch_contribution(imgs, seam_msks, orig_msks, bands: int,
                          sigma: float):
    """Per-image multiband (color, alpha) contributions of a (N, H, W, .)
    batch; accumulation over images commutes, so the contributions fold
    into a canvas in any order."""
    radius = int(np.ceil(3 * sigma))
    src = torch.cat([imgs, (seam_msks[..., None] > 0).to(torch.float32)], -1)
    sigmas = _band_sigmas(bands, sigma)
    blurred = {s: _blur_batch(src, s, radius) for s in set(sigmas)}
    color = torch.zeros_like(imgs)
    alpha = torch.zeros(imgs.shape[:3], dtype=torch.float32,
                        device=imgs.device)
    for i in range(bands):
        sb = sigmas[i]
        if i == bands - 1:
            band = imgs - blurred[sb][..., :3]
        elif i > 0:
            band = blurred[sb][..., :3] - blurred[sigmas[i + 1]][..., :3]
        else:
            band = blurred[sb][..., :3]
        w = torch.where(orig_msks > 0, blurred[sb][..., 3],
                        torch.zeros_like(alpha))
        color = color + band * w[..., None]
        alpha = alpha + w
    return color, alpha


def multi_blend(imgs, seam_msks, orig_msks, offs, canvas_hw,
                bands: int = 2, sigma: float = 7.0):
    """Multiband blending (blnd::multi_blend): ``bands`` Gaussian levels
    with sigma_band = sqrt(2(bands-i)+1) sigma, per-band weights = blurred
    seam masks zeroed outside the original footprint, accumulated on the
    canvas in image order."""
    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    radius = int(np.ceil(3 * sigma))
    dev = imgs.device
    offs = offs_list(offs)
    color = torch.zeros((H + Hb, W + Wb, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros((H + Hb, W + Wb), dtype=torch.float32, device=dev)
    src = torch.cat([imgs, (seam_msks[..., None] > 0).to(torch.float32)], -1)
    sigmas = _band_sigmas(bands, sigma)
    blurred = {s: _blur_batch(src, s, radius) for s in set(sigmas)}
    for i in range(bands):
        sb = sigmas[i]
        if i == bands - 1:
            band = imgs - blurred[sb][..., :3]
        elif i > 0:
            band = blurred[sb][..., :3] - blurred[sigmas[i + 1]][..., :3]
        else:
            band = blurred[sb][..., :3]
        w = torch.where(orig_msks > 0, blurred[sb][..., 3],
                        torch.zeros_like(orig_msks))
        for j, off in enumerate(offs):
            _acc_add(color, band[j] * w[j][..., None], off)
            _acc_add(alpha, w[j], off)
    out = color[:H, :W] / torch.clamp(alpha[:H, :W, None], min=1e-12)
    out = out * bands   # the reference divides by 255/bands; 0..255 kept
    return torch.where(alpha[:H, :W, None] > 0, out, torch.zeros_like(out))
