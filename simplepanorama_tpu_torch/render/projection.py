"""Rotation warpers: spherical / cylindrical / stereographic projections.

Port of simplepanorama_tpu/render/projection.py (proj::* of the
reference, which wraps OpenCV's RotationWarper family):

  * host (numpy): forward-map each image's border to its destination ROI
    (detectResultRoiByBorder semantics);
  * device: backward-map every destination pixel of a common padded ROI
    through the ray geometry and bilinearly sample the source; the
    footprint mask (in bounds and in front) is eroded 4 times with a 3x3
    min-pool, outside-is-black.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _forward_spherical(x, y, z, xp):
    u = xp.arctan2(x, z)
    n = xp.sqrt(x * x + y * y + z * z)
    v = xp.pi - xp.arccos(xp.clip(y / n, -1.0, 1.0))
    return u, v


def _backward_spherical(u, v):
    sinv = torch.sin(v)
    return sinv * torch.sin(u), -torch.cos(v), sinv * torch.cos(u)


def _forward_cylindrical(x, y, z, xp):
    return xp.arctan2(x, z), y / xp.sqrt(x * x + z * z)


def _backward_cylindrical(u, v):
    return torch.sin(u), v, torch.cos(u)


def _forward_stereographic(x, y, z, xp):
    u_ = xp.arctan2(x, z)
    n = xp.sqrt(x * x + y * y + z * z)
    v_ = xp.pi - xp.arccos(xp.clip(y / n, -1.0, 1.0))
    r = xp.sin(v_) / (1.0 - xp.cos(v_) + 1e-12)
    return r * xp.cos(u_), r * xp.sin(u_)


def _backward_stereographic(u, v):
    u_ = torch.atan2(v, u)
    r = torch.sqrt(u * u + v * v)
    v_ = 2.0 * torch.atan(1.0 / (r + 1e-12))
    sinv = torch.sin(v_)
    return sinv * torch.sin(u_), -torch.cos(v_), sinv * torch.cos(u_)


_PROJ = {
    "spherical": (_forward_spherical, _backward_spherical),
    "cylindrical": (_forward_cylindrical, _backward_cylindrical),
    "stereographic": (_forward_stereographic, _backward_stereographic),
}


def adjusted_K(K: np.ndarray, h: int, w: int) -> np.ndarray:
    """K with principal point (w - cx, h - cy) (_projection.cpp:38-42)."""
    Ka = np.array(K, np.float64)
    Ka[0, 2] = w - K[0, 2]
    Ka[1, 2] = h - K[1, 2]
    return Ka


def roi_for_image(kind: str, scale: float, R: np.ndarray, K: np.ndarray,
                  h: int, w: int, step: int = 4) -> Tuple[int, int, int, int]:
    """Destination ROI (tl_x, tl_y, width, height) by forward-mapping the
    source border, host-side numpy."""
    fwd, _ = _PROJ[kind]
    Ka = adjusted_K(K, h, w)
    xs = np.arange(0, w, step, dtype=np.float64)
    ys = np.arange(0, h, step, dtype=np.float64)
    border = np.concatenate([
        np.stack([xs, np.zeros_like(xs)], 1),
        np.stack([xs, np.full_like(xs, h - 1)], 1),
        np.stack([np.zeros_like(ys), ys], 1),
        np.stack([np.full_like(ys, w - 1), ys], 1)])
    pts = np.concatenate([border, np.ones((len(border), 1))], 1)
    rays = pts @ (np.asarray(R) @ np.linalg.inv(Ka)).T
    u, v = fwd(rays[:, 0], rays[:, 1], rays[:, 2], np)
    u = u * scale
    v = v * scale
    # 360-degree seam: unwrap a full-circle bbox to [0, 2 pi)
    if kind in ("spherical", "cylindrical") \
            and u.max() - u.min() > np.pi * scale:
        u = np.mod(u, 2 * np.pi * scale)
    tl_x = int(np.floor(u.min()))
    tl_y = int(np.floor(v.min()))
    br_x = int(np.ceil(u.max()))
    br_y = int(np.ceil(v.max()))
    return tl_x, tl_y, br_x - tl_x + 1, br_y - tl_y + 1


def _source_coords(K_adj, R, corner, scale, kind, yy, xx, valid_hw):
    """Backward-map canvas-ROI coordinates to source pixel coordinates.
    Returns (sx, sy, in-bounds mask)."""
    _, bwd = _PROJ[kind]
    u = (xx + corner[0]) / scale
    v = (yy + corner[1]) / scale
    dx, dy, dz = bwd(u, v)
    M = K_adj @ R.T
    px = M[0, 0] * dx + M[0, 1] * dy + M[0, 2] * dz
    py = M[1, 0] * dx + M[1, 1] * dy + M[1, 2] * dz
    pz = M[2, 0] * dx + M[2, 1] * dy + M[2, 2] * dz
    in_front = pz > 1e-9
    zs = torch.where(torch.abs(pz) < 1e-9, torch.full_like(pz, 1e-9), pz)
    sx = px / zs
    sy = py / zs
    h = valid_hw[0].to(torch.float32)
    w = valid_hw[1].to(torch.float32)
    inb = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1) & in_front
    return sx, sy, inb


def warp_backward(img, K_adj, R, corner, scale, kind: str, out_h: int,
                  out_w: int, valid_hw):
    """Backward-map warp of one (H, W, C) image into its padded
    destination ROI. Returns (warped (out_h, out_w, C), mask) — the mask
    not yet eroded."""
    dev = img.device
    yy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] \
        .expand(out_h, out_w)
    xx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :] \
        .expand(out_h, out_w)
    sx, sy, inb = _source_coords(K_adj, R, corner, scale, kind, yy, xx,
                                 valid_hw)
    H, W, C = img.shape
    x0 = torch.clamp(torch.floor(sx), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(sy), 0, H - 2).to(torch.int64)
    fx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]
    flat = img.reshape(H * W, C)
    lin = y0 * W + x0
    v00, v01 = flat[lin], flat[lin + 1]
    v10, v11 = flat[lin + W], flat[lin + W + 1]
    out = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
           + (v10 * (1 - fx) + v11 * fx) * fy)
    out = torch.where(inb[..., None], out, torch.zeros_like(out))
    return out, inb


def warp_backward_batch(imgs, K_adjs, Rs, corners, scale, kind: str,
                        out_h: int, out_w: int, valid_hws,
                        erode_iters: int = 4):
    """All images warped (one at a time, bounding the coordinate planes),
    footprint masks eroded. Returns ((N, out_h, out_w, C), (N, out_h,
    out_w) bool)."""
    warped, masks = [], []
    for i in range(imgs.shape[0]):
        w, m = warp_backward(imgs[i], K_adjs[i], Rs[i], corners[i], scale,
                             kind, out_h, out_w, valid_hws[i])
        warped.append(w)
        masks.append(m)
    return torch.stack(warped), erode_mask(torch.stack(masks), erode_iters)


def erode_mask(mask: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """3x3 min-pool erosion of (..., H, W) masks, borders forced to zero
    (blnd::erode + the 3x cv::erode in get_proj_parameters)."""
    H, W = mask.shape[-2:]
    shape = mask.shape
    m = mask.to(torch.float32).reshape(-1, 1, H, W)
    interior = torch.zeros((H, W), dtype=torch.float32, device=mask.device)
    interior[1:H - 1, 1:W - 1] = 1.0
    for _ in range(iters):
        m = -F.max_pool2d(-F.pad(m, (1, 1, 1, 1), value=1.0), 3, stride=1)
        m = m * interior
    return (m > 0.5).reshape(shape)


@dataclasses.dataclass
class ProjData:
    """Warped images/masks/corners (proj::proj_data); the crops are views
    of one padded batch on the device."""
    imgs: List[torch.Tensor]        # (h_i, w_i, 3) float32 per image
    masks: List[torch.Tensor]       # (h_i, w_i) bool
    corners: List[Tuple[int, int]]  # (tl_x, tl_y)


def get_proj_parameters(kind: str, scale: float,
                        images: Sequence[np.ndarray],
                        Rs: Sequence[np.ndarray],
                        Ks: Sequence[np.ndarray],
                        connectivity: Sequence[float],
                        device="cpu") -> ProjData:
    """Warp every connected image on ``device`` (proj::get_proj_parameters,
    _projection.cpp:422-454). Images are BGR uint8 or float; output floats
    keep the input scale."""
    sel = [i for i in range(len(images)) if connectivity[i] > 0]
    rois = {}
    for i in sel:
        h, w = images[i].shape[:2]
        rois[i] = roi_for_image(kind, scale, Rs[i], Ks[i], h, w)
    out_h = (max(rois[i][3] for i in sel) + 7) // 8 * 8
    out_w = (max(rois[i][2] for i in sel) + 127) // 128 * 128
    Hs = max(im.shape[0] for im in images)
    Ws = max(im.shape[1] for im in images)

    n = len(sel)
    src = torch.zeros((n, Hs, Ws, 3), dtype=torch.float32, device=device)
    Ka_b = np.zeros((n, 3, 3), np.float32)
    R_b = np.zeros((n, 3, 3), np.float32)
    c_b = np.zeros((n, 2), np.float32)
    hw_b = np.zeros((n, 2), np.int64)
    for b, i in enumerate(sel):
        h, w = images[i].shape[:2]
        src[b, :h, :w] = torch.as_tensor(images[i], device=device)
        Ka_b[b] = adjusted_K(Ks[i], h, w)
        R_b[b] = np.asarray(Rs[i], np.float32)
        c_b[b] = (rois[i][0], rois[i][1])
        hw_b[b] = (h, w)

    T = lambda a: torch.as_tensor(a, device=device)
    warped, masks = warp_backward_batch(
        src, T(Ka_b), T(R_b), T(c_b), float(scale), kind, out_h, out_w,
        T(hw_b), erode_iters=4)
    corners = [(rois[i][0], rois[i][1]) for i in sel]
    return ProjData(
        imgs=[warped[b, :rois[i][3], :rois[i][2]] for b, i in enumerate(sel)],
        masks=[masks[b, :rois[i][3], :rois[i][2]] for b, i in enumerate(sel)],
        corners=corners)
