"""Stereographic missing-centre fix.

Port of simplepanorama_tpu/render/sten_fix.py (sten_proj::{estimate_circle,
disk_reproj, inpaint} of the reference): find the near-centre hole of the
little-planet projection (connected components of the empty canvas
region, min enclosing circle, cutoffs at .2/.5 of the half-diagonal,
radius + 3), then radially stretch everything outside the hole with a
linear or quadratic profile so the hole closes, and finally
Navier-Stokes-inpaint the residual central speck after blending.

The per-pixel radial remap runs on the device, all images in one batched
call (bilinear sampling, as the JAX package). The hole analysis, the
float64 box arithmetic and the inpaint stay on the host, as in the JAX
package: cv2 on a uint8 canvas, numpy on a few hundred border points.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from simplepanorama_tpu_torch.geometry.canvas import get_pan_dimension
from simplepanorama_tpu_torch.render.blending import pad_stack
from simplepanorama_tpu_torch.render.projection import erode_mask


def estimate_circle(masks: Sequence, corners
                    ) -> Optional[Tuple[Tuple[int, int], float]]:
    """((cx, cy) in canvas coords, radius) of the central hole, or None
    (the reference prints 'No midsection found' and skips). ``masks`` are
    tensors (or numpy arrays for the CPU)."""
    import cv2
    sizes = [tuple(m.shape[:2]) for m in masks]
    d = get_pan_dimension(corners, sizes)
    dev = masks[0].device if torch.is_tensor(masks[0]) else "cpu"
    cover = torch.zeros((d.height, d.width), dtype=torch.bool, device=dev)
    for m, (tx, ty) in zip(masks, corners):
        h, w = m.shape[:2]
        y0, x0 = ty - d.min_y, tx - d.min_x
        cover[y0:y0 + h, x0:x0 + w] |= torch.as_tensor(m, device=dev) > 0
    # host, as in the JAX package: the component analysis is cv2 on the
    # uint8 canvas, downloaded once
    canvas = cover.to(torch.uint8).cpu().numpy() * np.uint8(255)
    hole = 255 - canvas
    if cv2.countNonZero(hole) == 0:
        return None
    ncomp, labels, stats, _ = cv2.connectedComponentsWithStats(hole)
    cx0, cy0 = d.width / 2.0, d.height / 2.0
    half_diag = np.sqrt(d.width ** 2 + d.height ** 2) / 2.0
    best = None
    best_dist = np.inf
    for i in range(1, ncomp):
        if stats[i, cv2.CC_STAT_AREA] < 100:
            continue
        # the JAX package's deviation from the reference
        # (analyzeComponentsWithCircles, _util.cpp:8-81): components that
        # touch the canvas border are skipped. The outer empty region
        # always does, and on symmetric (full-360) planets its canvas-
        # centred circle would win the distance tie, and the radius cutoff
        # then rejects the fix; a real central hole never reaches the
        # border.
        x0b, y0b = stats[i, cv2.CC_STAT_LEFT], stats[i, cv2.CC_STAT_TOP]
        wb, hb = stats[i, cv2.CC_STAT_WIDTH], stats[i, cv2.CC_STAT_HEIGHT]
        if x0b == 0 or y0b == 0 or x0b + wb >= d.width \
                or y0b + hb >= d.height:
            continue
        comp = (labels == i).astype(np.uint8) * 255
        contours, _ = cv2.findContours(comp, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        if not contours:
            continue
        (x, y), r = cv2.minEnclosingCircle(contours[0])
        dist = np.hypot(x - cx0, y - cy0)
        if dist < best_dist:
            best_dist = dist
            best = ((x, y), r)
    if best is None or best_dist > half_diag * 0.2 or best[1] > half_diag * 0.5:
        return None
    (x, y), r = best
    return (int(x), int(y)), float(r + 3.0)


def _radial_remap(img, src_mask, tr_origin, org_origin, center, scale: float,
                  radius: float, out_h: int, out_w: int, quadratic: bool,
                  valid_hw):
    """Backward radial stretch of a batch (disk_reproj inner loop,
    _projection.cpp:230-270): dst pixel -> normalised polar -> profile
    r_src = r^2 (2 - R) + R (quadratic) or r (1 - R) + R (linear) ->
    source pixel in the image's original box.

    img (N, H, W, 3) and src_mask (N, H, W) float32; tr_origin and
    org_origin (N, 2) float32 (x, y); center (2,) float32; valid_hw (N, 2)
    the true source (h, w). ``scale`` and ``radius`` are rounded to
    float32 first, as the JAX package traces them. Returns (warped
    (N, out_h, out_w, 3), mask (N, out_h, out_w) bool), the mask not yet
    eroded."""
    dev = img.device
    scale = float(np.float32(scale))
    radius = np.float32(radius)
    yy = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    tx, ty = tr_origin[:, 0, None, None], tr_origin[:, 1, None, None]
    px = (xx + tx - center[0]) * scale
    py = (yy + ty - center[1]) * scale
    r = torch.sqrt(px * px + py * py)
    phi = torch.atan2(py, px)
    if quadratic:
        r_src = r * r * float(np.float32(2.0) - radius) + float(radius)
    else:
        r_src = r * float(np.float32(1.0) - radius) + float(radius)
    sx = (torch.cos(phi) * r_src / scale + center[0]
          - org_origin[:, 0, None, None])
    sy = (torch.sin(phi) * r_src / scale + center[1]
          - org_origin[:, 1, None, None])

    h = valid_hw[:, 0, None, None].to(torch.float32)
    w = valid_hw[:, 1, None, None].to(torch.float32)
    inb = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    N, H, W, C = img.shape
    x0 = torch.clamp(torch.floor(sx), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(sy), 0, H - 2).to(torch.int64)
    fx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]
    lin = (y0 * W + x0).reshape(N, -1)
    flat = img.reshape(N, H * W, C)
    mflat = src_mask.reshape(N, H * W)

    def tap(k):
        idx = lin + k
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        m = torch.gather(mflat, 1, idx) > 0
        return (v.reshape(N, out_h, out_w, C), m.reshape(N, out_h, out_w))
    (v00, m00), (v01, m01) = tap(0), tap(1)
    (v10, m10), (v11, m11) = tap(W), tap(W + 1)
    out = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
           + (v10 * (1 - fx) + v11 * fx) * fy)
    m = m00 & m11 & m01 & m10 & inb
    return torch.where(inb[..., None], out, torch.zeros_like(out)), m


def _forward_profile(r, radius, quadratic):
    e = r * r if quadratic else r
    return np.where(e > radius, (e - radius) / (1.0 - radius), r)


def disk_reproj(imgs, masks, corners, center_xy, radius_px,
                quadratic: bool = True):
    """Apply the radial stretch to all warped images (tensors on one
    device). Returns (imgs, masks, corners, ansatz) with the corners
    re-centred like the reference (canvas centre at the origin); the new
    blocks are crops of one batch on the same device."""
    sizes = [tuple(im.shape[:2]) for im in imgs]
    d = get_pan_dimension(corners, sizes)
    # host float64 box arithmetic, as in the JAX package: the boxes and
    # corners come out bit for bit the same
    half = (d.width // 2 + 1, d.height // 2 + 1)
    ansatz = (center_xy[0] - half[0], center_xy[1] - half[1])
    new_corners = [(tx - d.min_x - half[0], ty - d.min_y - half[1])
                   for tx, ty in corners]
    pts = []
    for (tx, ty), (h, w) in zip(new_corners, sizes):
        pts += [(tx, ty), (tx + w, ty), (tx + w, ty + h), (tx, ty + h)]
    dists = [np.hypot(px - ansatz[0], py - ansatz[1]) for px, py in pts]
    scale = 1.0 / max(1e-6, max(dists))
    radius_n = radius_px * scale

    # transformed bounding boxes via forward-mapped borders
    tr_boxes = []
    for (tx, ty), (h, w) in zip(new_corners, sizes):
        bx = np.linspace(tx, tx + w, 256)
        by = np.linspace(ty, ty + h, 256)
        border = np.concatenate([
            np.stack([bx, np.full_like(bx, ty)], 1),
            np.stack([bx, np.full_like(bx, ty + h)], 1),
            np.stack([np.full_like(by, tx), by], 1),
            np.stack([np.full_like(by, tx + w), by], 1)])
        nx = (border[:, 0] - ansatz[0]) * scale
        ny = (border[:, 1] - ansatz[1]) * scale
        r = np.hypot(nx, ny)
        phi = np.arctan2(ny, nx)
        r2 = _forward_profile(r, radius_n, quadratic)
        ux = np.cos(phi) * r2 / scale + ansatz[0]
        uy = np.sin(phi) * r2 / scale + ansatz[1]
        tr_boxes.append((int(np.floor(ux.min())), int(np.floor(uy.min())),
                         int(np.ceil(ux.max() - ux.min())) + 1,
                         int(np.ceil(uy.max() - uy.min())) + 1))

    out_h = (max(b[3] for b in tr_boxes) + 7) // 8 * 8
    out_w = (max(b[2] for b in tr_boxes) + 127) // 128 * 128
    # sources padded to the largest unpadded ROI, as the JAX package pads
    # them: the taps are clipped to this shape
    Hs = max(s[0] for s in sizes)
    Ws = max(s[1] for s in sizes)
    dev = imgs[0].device
    T = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt, device=dev)
    warped, mask = _radial_remap(
        pad_stack(imgs, (Hs, Ws, 3), dev), pad_stack(masks, (Hs, Ws), dev),
        T([b[:2] for b in tr_boxes], torch.float32),
        T(new_corners, torch.float32), T(ansatz, torch.float32), scale,
        radius_n, out_h, out_w, bool(quadratic), T(sizes, torch.int64))
    # eroded on the padded block, before the crop: the remap has values
    # beyond each box too
    mask = erode_mask(mask, iters=4)
    new_imgs = [warped[i, :b[3], :b[2]] for i, b in enumerate(tr_boxes)]
    new_masks = [mask[i, :b[3], :b[2]] for i, b in enumerate(tr_boxes)]
    return new_imgs, new_masks, [b[:2] for b in tr_boxes], ansatz


def inpaint_center(img: np.ndarray, ansatz_canvas, radius) -> np.ndarray:
    """Navier-Stokes inpaint of the residual central speck
    (sten_proj::inpaint, _projection.cpp:327-358); host cv2 on the
    finished uint8 panorama, as in the JAX package."""
    import cv2
    h, w = img.shape[:2]
    x0 = int(ansatz_canvas[0] - w // 8)
    y0 = int(ansatz_canvas[1] - h // 8)
    x0 = max(0, min(w - w // 4 - 1, x0))
    y0 = max(0, min(h - h // 4 - 1, y0))
    roi = img[y0:y0 + h // 4, x0:x0 + w // 4]
    gray = (0.114 * roi[..., 0] + 0.587 * roi[..., 1]
            + 0.299 * roi[..., 2]).astype(np.uint8)
    roi_mask = (gray <= 1).astype(np.uint8) * 255
    mask = np.zeros((h, w), np.uint8)
    mask[y0:y0 + h // 4, x0:x0 + w // 4] = roi_mask
    return cv2.inpaint(img.astype(np.uint8), mask, 3, cv2.INPAINT_NS)


def apply_center_fix(params, cfg) -> None:
    """estimate_circle + disk_reproj of the preview blocks; the state is
    repacked on its device and the inpaint anchor kept for after the blend
    (set_config, _panorama.cpp:103-124)."""
    from simplepanorama_tpu_torch.config import Stretch
    from simplepanorama_tpu_torch.stitcher import _pack_state
    imgs_l, masks_l, corners_l = params._lists()
    est = estimate_circle(masks_l, corners_l)
    if est is None:
        params.sten_circle = None
        return
    (cx, cy), r = est
    quad = cfg.stretching == Stretch.QUADRATIC_SCALING
    imgs, masks, corners, ansatz = disk_reproj(
        imgs_l, masks_l, corners_l, (cx, cy), r, quad)
    params.state = _pack_state(imgs, masks, corners)
    params.sten_circle = (ansatz, r)
