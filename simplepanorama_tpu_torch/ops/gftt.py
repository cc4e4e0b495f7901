"""GFTT (Shi-Tomasi) corners with SIFT descriptors.

Port of simplepanorama_tpu/ops/gftt.py (the reference's alternative
detector path util::extract_keypoints_detGFTT_descSIFT,
_homography.cpp:754-792, kept but unused there, as here: the pipeline
does not call it). The structure tensor's minimum eigenvalue (or the
Harris response) over a box window, a quality-level threshold,
non-maximum suppression by a max-pool over the min-distance window, and
the top ``max_corners`` by response (ties to the lower index, as
lax.top_k); the descriptors are the SIFT ones of ops/sift.py at a fixed
patch scale on one blurred level.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from simplepanorama_tpu_torch.ops.sift import (SiftFeatures, _blur,
                                               _descriptor, _orientation,
                                               _topk_stable, grad_stack)


def _conv_same(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Cross-correlation of an (H, W) image with an odd (kh, kw) kernel,
    zero padding, output (H, W) (lax.conv_general_dilated "SAME")."""
    kh, kw = k.shape
    return F.conv2d(img[None, None], k[None, None],
                    padding=(kh // 2, kw // 2))[0, 0]


def _sobel(img: torch.Tensor):
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=img.device)
    return _conv_same(img, kx), _conv_same(img, kx.T.contiguous())


def gftt_detect(img_gray: torch.Tensor, valid_hw, max_corners: int = 1024,
                quality_level: float = 0.01, min_distance: int = 8,
                block_size: int = 3, use_harris: bool = False,
                harris_k: float = 0.04
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Corner positions by Shi-Tomasi minimum-eigenvalue (or Harris)
    response of an (H, W) float32 image whose content fills its top-left
    ``valid_hw`` = (h, w). Returns (xy (K, 2), response (K,), valid (K,))
    with K = ``max_corners``."""
    img = img_gray.to(torch.float32)
    gx, gy = _sobel(img)
    box = torch.ones((block_size, block_size), device=img.device)
    axx = _conv_same(gx * gx, box)
    ayy = _conv_same(gy * gy, box)
    axy = _conv_same(gx * gy, box)
    if use_harris:
        resp = (axx * ayy - axy * axy) - harris_k * (axx + ayy) ** 2
    else:
        tr = 0.5 * (axx + ayy)
        det = axx * ayy - axy * axy
        resp = tr - torch.sqrt(torch.clamp(tr * tr - det, min=0.0))

    H, W = img.shape
    vh, vw = (int(v) for v in valid_hw)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inb = (xx >= 4) & (xx < vw - 4) & (yy >= 4) & (yy < vh - 4)
    resp = torch.where(inb, resp, torch.zeros_like(resp))

    # NMS over the min-distance window + quality-level threshold
    k = 2 * min_distance + 1
    mx = F.max_pool2d(resp[None, None], k, stride=1,
                      padding=min_distance)[0, 0]
    peak = (resp >= mx) & (resp >= quality_level * resp.max())
    score = torch.where(peak, resp, torch.zeros_like(resp)).reshape(-1)
    vals, idx = _topk_stable(score, max_corners)
    xs = (idx % W).to(torch.float32)
    ys = (idx // W).to(torch.float32)
    return torch.stack([xs, ys], -1), vals, vals > 0


def gftt_sift(img_gray: torch.Tensor, valid_hw, max_corners: int = 1024,
              patch_scale: float = 3.0) -> SiftFeatures:
    """GFTT corners with SIFT descriptors at a fixed patch scale (the
    reference's alternative path describes size-less keypoints), sampled
    on one level blurred by sigma 1. Returns SiftFeatures without the
    batch dimension."""
    xy, resp, valid = gftt_detect(img_gray, valid_hw,
                                  max_corners=max_corners)
    img = img_gray.to(torch.float32)
    H, W = img.shape
    K = xy.shape[0]
    flat = grad_stack(_blur(img, 1.0)).reshape(1, -1, 2)
    kp = lambda v: torch.full((1, K), v, dtype=torch.int64,
                              device=img.device)
    pyr = (flat, kp(0), kp(H), kp(W))
    l = kp(0)
    so = torch.full((1, K), patch_scale, dtype=torch.float32,
                    device=img.device)
    x, y = xy[None, :, 0], xy[None, :, 1]
    a = _orientation(pyr, l, y, x, so)
    desc = _descriptor(pyr, l, y, x, so, a)[0]
    l1 = torch.sum(torch.abs(desc), dim=1, keepdim=True)
    desc = torch.sqrt(desc / torch.clamp(l1, min=1e-12))
    v = valid[:, None]
    return SiftFeatures(
        xy=torch.where(v, xy, torch.zeros_like(xy)),
        size=torch.full_like(resp, patch_scale * 2),
        response=torch.where(valid, resp, torch.zeros_like(resp)),
        desc=torch.where(v, desc, torch.zeros_like(desc)), valid=valid)
