"""Device-resident compositing: warp -> seams -> exposure -> blend.

Port of simplepanorama_tpu/render/compose.py. The packed block tensors
stay on the device end to end; the host sees only metadata (ROIs,
offsets) and the final uint8 panorama. Data model:
  imgs  (N, Hb, Wb, 3) float32 (0..255), Hb padded to 8, Wb to 128
  masks (N, Hb, Wb)    bool
  offs  (N, 2) int32   block top-left on the canvas (y, x)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simplepanorama_tpu_torch.geometry.canvas import get_pan_dimension
from simplepanorama_tpu_torch.ops.edt import distance_transform
from simplepanorama_tpu_torch.render import projection as prj
from simplepanorama_tpu_torch.render.blending import (
    multi_blend, no_blend, offs_list, simple_blend)
from simplepanorama_tpu_torch.utils.device import checked_device


@dataclasses.dataclass
class ComposeState:
    """Packed device blocks + host metadata."""
    imgs: torch.Tensor           # (N, Hb, Wb, 3) f32
    masks: torch.Tensor          # (N, Hb, Wb) bool
    offs: torch.Tensor           # (N, 2) int32 canvas (y, x)
    rois: List[Tuple[int, int, int, int]]  # (tlx, tly, w, h) per image
    canvas_hw: Tuple[int, int]
    min_xy: Tuple[int, int]      # canvas origin in projection coords
    seam_masks: Optional[torch.Tensor] = None   # (N, Hb, Wb) bool
    gains: Optional[np.ndarray] = None
    intensity: Optional[torch.Tensor] = None    # (N, Hb/2, Wb/2) fields


def warp_all(kind: str, scale: float, images: Sequence[np.ndarray],
             Rs, Ks, connectivity, dev_images=None,
             device="cuda") -> ComposeState:
    """Batched warp; blocks stay on ``device``.

    ``dev_images``: optional (batch_u8, rows) — the padded uint8 batch the
    SIFT stage already holds on the device, plus the batch row of each
    entry of ``images``; the warp then samples it instead of uploading
    the images again."""
    sel = [i for i in range(len(images)) if connectivity[i] > 0]
    rois = {}
    for i in sel:
        h, w = images[i].shape[:2]
        rois[i] = prj.roi_for_image(kind, scale, Rs[i], Ks[i], h, w)
    out_h = (max(rois[i][3] for i in sel) + 7) // 8 * 8
    out_w = (max(rois[i][2] for i in sel) + 127) // 128 * 128

    n = len(sel)
    Ka_b = np.zeros((n, 3, 3), np.float32)
    R_b = np.zeros((n, 3, 3), np.float32)
    c_b = np.zeros((n, 2), np.float32)
    hw_b = np.zeros((n, 2), np.int64)
    for b, i in enumerate(sel):
        h, w = images[i].shape[:2]
        Ka_b[b] = prj.adjusted_K(Ks[i], h, w)
        R_b[b] = np.asarray(Rs[i], np.float32)
        c_b[b] = (rois[i][0], rois[i][1])
        hw_b[b] = (h, w)

    if dev_images is not None:
        batch_u8, rows = dev_images
        sel_rows = torch.as_tensor([rows[i] for i in sel],
                                   device=batch_u8.device)
        src = batch_u8[sel_rows].to(torch.float32)
        device = batch_u8.device
    else:
        device = checked_device(device)
        Hs = max(im.shape[0] for im in images)
        Ws = max(im.shape[1] for im in images)
        imgs_b = np.zeros((n, Hs, Ws, 3), np.float32)
        for b, i in enumerate(sel):
            h, w = images[i].shape[:2]
            imgs_b[b, :h, :w] = images[i].astype(np.float32)
        src = torch.as_tensor(imgs_b, device=device)

    T = lambda a: torch.as_tensor(a, device=device)
    warped, masks = prj.warp_backward_batch(
        src, T(Ka_b), T(R_b), T(c_b), float(scale), kind, out_h, out_w,
        T(hw_b), erode_iters=4)

    roi_list = [rois[i] for i in sel]
    corners = [(r[0], r[1]) for r in roi_list]
    d = get_pan_dimension(corners, [(r[3], r[2]) for r in roi_list])
    offs = np.array([[ty - d.min_y, tx - d.min_x] for (tx, ty) in corners],
                    np.int32)
    # zero the block padding beyond each image's true ROI
    yy = np.arange(out_h)[None, :, None]
    xx = np.arange(out_w)[None, None, :]
    rh = np.array([r[3] for r in roi_list])[:, None, None]
    rw = np.array([r[2] for r in roi_list])[:, None, None]
    masks = masks & T((yy < rh) & (xx < rw))
    return ComposeState(imgs=warped, masks=masks, offs=T(offs),
                        rois=roi_list, canvas_hw=(d.height, d.width),
                        min_xy=(d.min_x, d.min_y))


def dist_cut_dev(msks, offs, canvas_hw):
    """Distance-transform seams on packed blocks: each pixel goes to the
    image whose footprint is deepest there."""
    H, W = canvas_hw
    N, Hb, Wb = msks.shape
    offs = offs_list(offs)
    dts = distance_transform(msks)
    dmax = torch.zeros((H + Hb, W + Wb), dtype=torch.float32,
                       device=msks.device)
    for i, (y, x) in enumerate(offs):
        sl = dmax[y:y + Hb, x:x + Wb]
        dmax[y:y + Hb, x:x + Wb] = torch.maximum(sl, dts[i])
    return torch.stack([msks[i] & (dts[i] >= dmax[y:y + Hb, x:x + Wb])
                        for i, (y, x) in enumerate(offs)])


def equalize_dev(imgs, msks, offs, canvas_hw,
                 ratio_shift: int = 1):
    """Exposure-disparity fields (test::equalizeIntensities at ratio .5):
    gray at half resolution by 2x2 mean pooling, distance-weighted
    neighbour mean, correction = own / (blended + eps) + eps, smoothed
    by a 13-tap Gaussian (sigma 7) with edge padding."""
    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    eps = 1e-5
    r = 1 << ratio_shift
    hb, wb = Hb // r, Wb // r
    dev = imgs.device

    gray = (0.114 * imgs[..., 0] + 0.587 * imgs[..., 1]
            + 0.299 * imgs[..., 2]) / 255.0
    dts = distance_transform(msks) / 255.0

    def down(x):
        return x.reshape(N, hb, r, wb, r).mean(dim=(2, 4))

    gs = down(torch.where(msks, gray, torch.zeros_like(gray)))
    ds = down(dts)
    ms = down(msks.to(torch.float32)) > 0.5
    offs_s = [(y // r, x // r) for y, x in offs_list(offs)]
    Hc, Wc = H // r + hb, W // r + wb

    int_dist = gs * ds
    cint = torch.zeros((Hc, Wc), dtype=torch.float32, device=dev)
    cw = torch.zeros((Hc, Wc), dtype=torch.float32, device=dev)
    for i, (y, x) in enumerate(offs_s):
        cint[y:y + hb, x:x + wb] += int_dist[i]
        cw[y:y + hb, x:x + wb] += ds[i]

    radius = 6
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(t * t) / (2.0 * 49.0))
    k = torch.as_tensor((k / k.sum()).astype(np.float32), device=dev)

    acc_i = torch.stack([cint[y:y + hb, x:x + wb] for y, x in offs_s])
    acc_w = torch.stack([cw[y:y + hb, x:x + wb] for y, x in offs_s])
    blended = acc_i / (acc_w + eps) + eps
    corr = torch.where(ms, gs / blended, torch.zeros_like(gs)) + (~ms).to(gs.dtype)
    c = F.pad(corr[:, None], (radius, radius, 0, 0), mode="replicate")
    c = F.conv2d(c, k.view(1, 1, 1, -1))
    c = F.pad(c, (0, 0, radius, radius), mode="replicate")
    c = F.conv2d(c, k.view(1, 1, -1, 1))
    return c[:, 0]


def apply_intensity_dev(imgs, fields):
    """Upsample the half-resolution fields to block size (half-pixel
    linear x2, as jax.image.resize "linear") and divide."""
    N, Hb, Wb, _ = imgs.shape
    up = F.interpolate(fields[:, None], size=(Hb, Wb), mode="bilinear",
                       align_corners=False)[:, 0]
    up = torch.where(torch.abs(up) < 1e-6, torch.ones_like(up), up)
    return imgs / up[..., None]


def gain_dev(imgs, msks, offs, canvas_hw, adj) -> np.ndarray:
    """Gain compensation on packed blocks (Brown & Lowe §6 eq. 29,
    gain::gain_compensation, _gain_compensation.cpp:78-172): pairwise
    overlap areas and intensity sums on the device, the small solve in
    float64 on the host. Returns the (N,) gains of the state's rows."""
    n = imgs.shape[0]
    gray = (0.114 * imgs[..., 0] + 0.587 * imgs[..., 1]
            + 0.299 * imgs[..., 2])
    N_mat, S_mat = _overlap_sums_dev(gray, msks, offs, canvas_hw)
    N_np = N_mat.cpu().numpy().astype(np.float64)
    S_np = S_mat.cpu().numpy().astype(np.float64)
    adj_sym = np.asarray(adj) + np.asarray(adj).T + np.eye(n)
    use = adj_sym > 0
    N_np = np.where(use & (N_np > 0), N_np, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        I = np.where(N_np > 0, S_np / N_np, 0.0)
    Iref = I.T
    S_N, S_g = 100.0, 0.01
    B = np.diag(N_np.sum(axis=1))
    A = np.diag((N_np * Iref * Iref).sum(axis=1))
    C = N_np * Iref * Iref.T
    G = (1.0 / S_g) * np.diag(B)
    M = (2.0 / S_N) * (A - C) + (1.0 / S_g) * B
    try:
        return np.linalg.solve(M, G)
    except np.linalg.LinAlgError:
        return np.ones(n)


def _overlap_sums_dev(grays, msks, offs, canvas_hw):
    """(N, N) overlap areas and masked intensity sums: every block pasted
    into its own canvas plane, then two products of the flattened
    stacks (N_ij = |M_i & M_j|, S_ij = sum of gray_i over M_i & M_j)."""
    H, W = canvas_hw
    n, Hb, Wb = grays.shape
    cm = torch.zeros((n, H + Hb, W + Wb), dtype=torch.float32,
                     device=grays.device)
    cg = torch.zeros_like(cm)
    for i, (y, x) in enumerate(offs_list(offs)):
        m = msks[i].to(torch.float32)
        cm[i, y:y + Hb, x:x + Wb] = m
        cg[i, y:y + Hb, x:x + Wb] = grays[i] * m
    fm = cm.reshape(n, -1)
    fg = cg.reshape(n, -1)
    return fm @ fm.T, fg @ fm.T


def blend_dev(method: str, state: ComposeState, imgs, bands: int,
              sigma: float) -> np.ndarray:
    """Blend packed blocks -> uint8 numpy panorama (one transfer).

    MULTI_BLEND is a sum over images, so in a world of several ranks it
    takes the rank-sharded schedule (parallel/tiled_compose.py: band
    pyramids split over the images, the canvas reduce-scattered by
    columns). NO and SIMPLE composite in order and stay single-device."""
    from simplepanorama_tpu_torch.parallel.mesh import pipeline_mesh
    mesh = pipeline_mesh()
    offs = state.offs
    msks_f = state.masks.to(torch.float32)
    if method == "NO_BLEND":
        use = state.seam_masks if state.seam_masks is not None else state.masks
        out = no_blend(imgs, use.to(torch.float32), offs, state.canvas_hw)
    elif method == "SIMPLE_BLEND":
        out = simple_blend(imgs, msks_f, offs, state.canvas_hw)
    elif mesh is not None:
        from simplepanorama_tpu_torch.parallel.tiled_compose import \
            multi_blend_sharded
        out = multi_blend_sharded(imgs, state.seam_masks.to(torch.float32),
                                  msks_f, offs, state.canvas_hw, mesh,
                                  bands=bands,
                                  sigma=float(sigma))
    else:
        out = multi_blend(imgs, state.seam_masks.to(torch.float32), msks_f,
                          offs, state.canvas_hw, bands=bands,
                          sigma=float(sigma))
    return _to_u8(out).cpu().numpy()


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)
