"""Flat-plane (projective) rendering: homography warps, the legacy
pairwise stitch, and the chained-homography panorama without BA.

Port of simplepanorama_tpu/render/flat.py (imgm::applyGeometricTransform,
_img_manipulation.h:58-83; imgm::stitch, _img_manipulation.cpp:178-212;
the flat use of imgm::calc_stitch_from_adj / pan_img_transform,
_img_manipulation.cpp:281-390). No Config path reaches it; it is the
projective composite the reference builds before bundle adjustment
replaces it with rotations. The warp is one backward-map bilinear gather
per destination pixel; compositing pastes in chain order on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from simplepanorama_tpu_torch.geometry.canvas import (PanImgTransform,
                                                      get_translation)
from simplepanorama_tpu_torch.utils.device import checked_device


def warp_perspective(img: torch.Tensor, H_inv: torch.Tensor, out_h: int,
                     out_w: int):
    """Inverse-map homography warp (applyGeometricTransform): every
    destination pixel samples the (Hs, Ws, C) float32 source at
    H_inv @ (x, y, 1), bilinearly. Returns (warped (out_h, out_w, C)
    float32, mask bool), on the source's device."""
    dev = img.device
    H_inv = torch.as_tensor(H_inv, dtype=torch.float32, device=dev)
    yy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] \
        .expand(out_h, out_w)
    xx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :] \
        .expand(out_h, out_w)
    px = H_inv[0, 0] * xx + H_inv[0, 1] * yy + H_inv[0, 2]
    py = H_inv[1, 0] * xx + H_inv[1, 1] * yy + H_inv[1, 2]
    pz = H_inv[2, 0] * xx + H_inv[2, 1] * yy + H_inv[2, 2]
    zs = torch.where(torch.abs(pz) < 1e-12, torch.full_like(pz, 1e-12), pz)
    sx = px / zs
    sy = py / zs
    Hs, Ws = img.shape[:2]
    inb = (sx >= 0) & (sx <= Ws - 1) & (sy >= 0) & (sy <= Hs - 1) & (pz > 0)
    x0 = torch.clamp(torch.floor(sx), 0, Ws - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(sy), 0, Hs - 2).to(torch.int64)
    fx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]
    out = ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
           + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)
    return torch.where(inb[..., None], out, torch.zeros_like(out)), inb


def pairwise_stitch(base: np.ndarray, attach: np.ndarray, H: np.ndarray,
                    device="cuda") -> np.ndarray:
    """Legacy two-image stitch (imgm::stitch): warp ``attach`` by H into
    the base plane on ``device`` (the card unless the caller asks for
    another), allocate the union canvas, paste base on top where it has
    content. ``H`` maps attach coordinates into base coordinates."""
    device = checked_device(device)
    T, xs, xe, ys, ye = get_translation(base.shape[:2], attach.shape[:2],
                                        np.asarray(H, np.float64))
    out_w = int(xe - xs + 1)
    out_h = int(ye - ys + 1)
    TH = T @ np.asarray(H, np.float64)
    warped, _ = warp_perspective(
        torch.as_tensor(attach.astype(np.float32), device=device),
        torch.as_tensor(np.linalg.inv(TH).astype(np.float32)), out_h, out_w)
    pano = warped.cpu().numpy()
    bx, by = int(-xs), int(-ys)
    bh, bw = base.shape[:2]
    roi = pano[by:by + bh, bx:bx + bw]
    basef = base.astype(np.float32)
    nz = basef.sum(axis=-1, keepdims=True) > 0
    pano[by:by + bh, bx:bx + bw] = np.where(nz, basef, roi)
    return np.clip(pano, 0, 255).astype(np.uint8)


def render_flat(transform: PanImgTransform, images: Sequence[np.ndarray],
                device="cuda") -> np.ndarray:
    """Composite the chained-homography flat panorama (the reference's
    pre-BA projective layout): each image is warped on ``device`` (the
    card unless the caller asks for another) by its img_to_pan chain onto
    the shared canvas, pasted in order of falling connectivity with the
    first image winning where footprints overlap."""
    device = checked_device(device)
    ph, pw = transform.pan_hw
    if ph <= 0 or pw <= 0:
        raise RuntimeError("Flat panorama dimensions out of range")
    acc = np.zeros((ph, pw, 3), np.float32)
    filled = np.zeros((ph, pw), bool)
    order = np.argsort(-np.asarray(transform.connectivity))
    for i in order:
        if transform.connectivity[i] <= 0 and i != transform.center:
            continue
        Hinv = np.linalg.inv(transform.img_to_pan[i])
        warped, mask = warp_perspective(
            torch.as_tensor(images[i].astype(np.float32), device=device),
            torch.as_tensor(Hinv.astype(np.float32)), ph, pw)
        warped = warped.cpu().numpy()
        mask = mask.cpu().numpy() & ~filled
        acc[mask] = warped[mask]
        filled |= mask
    return np.clip(acc, 0, 255).astype(np.uint8)
