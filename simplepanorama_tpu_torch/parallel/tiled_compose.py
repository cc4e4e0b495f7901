"""Canvas-sharded compositing: the panorama canvas split across ranks.

Port of simplepanorama_tpu/parallel/tiled_compose.py on torch.distributed
(the reference composites on one CPU: blnd::multi_blend,
_blending.cpp:186-252; proj::get_proj_parameters, _projection.cpp:422-454).

* ``multi_blend_sharded``: the band pyramids (the per-image, per-band
  blurs that hold most of the work) are split over the ranks by image;
  each rank accumulates its images' colour and weight on a whole canvas,
  then one reduce_scatter per accumulator sums them across ranks and
  leaves each rank a slab of canvas columns, which it normalises; an
  all_gather puts the panorama together. Multiband blending is a sum over
  images, so the schedule is exact up to float order; NO_BLEND and
  SIMPLE_BLEND composite in order and stay single-device.
* ``warp_tiled``: each rank backward-maps its slab of canvas columns
  (inverse warping needs no communication); the slabs are gathered.
* ``fullres_multi_dp`` / ``fullres_multi_canvas``: the two schedules of
  the full-resolution render (images split across ranks, or the canvas).
* ``halo_exchange``: the neighbouring ranks' edge columns for stencils on
  column slabs (blurs, erosions, the sharded min-cut), by point-to-point
  sends.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from simplepanorama_tpu_torch.parallel.mesh import (Mesh, all_gather_cat,
                                                    pad_leading,
                                                    reduce_scatter_columns,
                                                    shard_range)
from simplepanorama_tpu_torch.render import projection as prj
from simplepanorama_tpu_torch.render.blending import (_acc_add,
                                                      _band_sigmas,
                                                      _gauss_taps, offs_list,
                                                      mb_batch_contribution)


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh,
                  fill: float = 0.0) -> torch.Tensor:
    """Pad this rank's column slab ``x`` (H, Ws, ...) with ``halo`` columns
    from each neighbouring rank: rank d gets rank d-1's last columns on its
    left and rank d+1's first on its right, ``fill`` at the ends of the
    ring. Returns (H, Ws + 2 halo, ...). Every rank of the mesh must call
    it; ``halo`` <= Ws."""
    W = x.shape[1]
    if halo > W:
        raise ValueError(f"halo {halo} wider than the slab's {W} columns")
    left_edge = x[:, :halo].contiguous()
    right_edge = x[:, W - halo:].contiguous()
    from_left = torch.full_like(left_edge, fill)
    from_right = torch.full_like(right_edge, fill)
    ops = []
    if mesh.rank > 0:
        ops += [dist.P2POp(dist.isend, left_edge, mesh.rank - 1, mesh.group),
                dist.P2POp(dist.irecv, from_left, mesh.rank - 1, mesh.group)]
    if mesh.rank < mesh.size - 1:
        ops += [dist.P2POp(dist.isend, right_edge, mesh.rank + 1,
                           mesh.group),
                dist.P2POp(dist.irecv, from_right, mesh.rank + 1,
                           mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_left, x, from_right], 1)


def _finish_slab(color, alpha, bands: int):
    """A normalised multiband slab: colour / weight * bands where any
    weight landed, else 0."""
    out = color / torch.clamp(alpha[..., None], min=1e-12) * bands
    return torch.where(alpha[..., None] > 0, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# multiband blend: images split over ranks + canvas reduce_scatter
# ---------------------------------------------------------------------------

def multi_blend_sharded(imgs, seam_msks, orig_msks, offs,
                        canvas_hw: Tuple[int, int], mesh: Mesh,
                        bands: int = 2, sigma: float = 7.0) -> torch.Tensor:
    """blending.multi_blend with the image batch split over ``mesh``.
    Every rank passes the whole batch (N, Hb, Wb, ...) and blends its
    contiguous share of the images (a rank may have none); the (H, W, 3)
    panorama comes back on every rank."""
    H, W = canvas_hw
    N, Hb, Wb, _ = imgs.shape
    offs = offs_list(offs)
    Hc = H + Hb
    Wc = pad_leading(W + Wb, mesh.size)
    dev = imgs.device
    color = torch.zeros((Hc, Wc, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros((Hc, Wc), dtype=torch.float32, device=dev)
    lo, hi = shard_range(N, mesh)
    if hi > lo:
        c, a = mb_batch_contribution(imgs[lo:hi].to(torch.float32),
                                     seam_msks[lo:hi].to(torch.float32),
                                     orig_msks[lo:hi].to(torch.float32),
                                     bands, float(sigma))
        for j in range(hi - lo):
            _acc_add(color, c[j], offs[lo + j])
            _acc_add(alpha, a[j], offs[lo + j])
    color = reduce_scatter_columns(color, mesh)
    alpha = reduce_scatter_columns(alpha, mesh)
    out = all_gather_cat(_finish_slab(color, alpha, bands), mesh, dim=1)
    return out[:H, :W]


# ---------------------------------------------------------------------------
# tiled backward warp: canvas columns split over ranks
# ---------------------------------------------------------------------------

def _slab_grid(out_h: int, Ws: int, x0: int, device):
    yy = torch.arange(out_h, dtype=torch.float32, device=device)[:, None] \
        .expand(out_h, Ws)
    xx = (torch.arange(Ws, dtype=torch.float32, device=device)
          + float(x0))[None, :].expand(out_h, Ws)
    return yy, xx


def warp_tiled(img, K_adj, R, corner, scale, kind: str, out_h: int,
               out_w: int, valid_hw, mesh: Mesh):
    """projection.warp_backward with the destination ROI column-sharded:
    rank d maps canvas columns [d Ws, (d+1) Ws) of the source (the same
    on every rank); the slabs are gathered, so every rank returns the
    whole (warped, mask)."""
    Ws = pad_leading(out_w, mesh.size) // mesh.size
    yy, xx = _slab_grid(out_h, Ws, mesh.rank * Ws, img.device)
    warped, mask = prj.warp_from_grid(img, K_adj, R, corner, scale, kind,
                                      yy, xx, valid_hw)
    warped = all_gather_cat(warped, mesh, dim=1)[:, :out_w]
    mask = all_gather_cat(mask, mesh, dim=1)[:, :out_w]
    return warped, mask


# ---------------------------------------------------------------------------
# full-resolution multiband render: two schedules
# ---------------------------------------------------------------------------

def _blur_slab(x, sigma: float, radius: int, mesh: Mesh):
    """Separable fixed-radius Gaussian of a column slab (H, Ws[, C]) of
    the canvas: the ``radius`` neighbouring columns come from
    halo_exchange, rows are local; zero beyond the canvas, like the block
    zero padding of the single-device blend."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    C = x.shape[2]
    k = _gauss_taps(sigma, radius, x.device)
    xp = halo_exchange(x, radius, mesh, fill=0.0)
    xx = xp.permute(2, 0, 1)[None]
    xx = F.conv2d(xx, k.view(1, 1, 1, -1).expand(C, 1, 1, -1), groups=C)
    xx = F.conv2d(xx, k.view(1, 1, -1, 1).expand(C, 1, -1, 1),
                  padding=(radius, 0), groups=C)
    out = xx[0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def _erode_slab(m, iters: int, mesh: Mesh):
    """3x3 min-pool erosion, ``iters`` times, of a boolean column slab with
    halo exchange; outside the canvas counts as background (equivalent to
    projection.erode_mask's border rule: a footprint pixel on its ROI's
    edge always has a background neighbour)."""
    mp = halo_exchange(m.to(torch.float32), iters, mesh, fill=0.0)
    mp = F.pad(mp, (0, 0, iters, iters))[None, None]
    for _ in range(iters):
        mp = -F.max_pool2d(-mp, 3, stride=1)
    return mp[0, 0] > 0.5


def fullres_multi_dp(src_u8, block_hw, Ka, R, corner, vhw, roi_wh, offs,
                     seam_blks, seam_ratios, field_blks, field_ratios,
                     gains, scale: float, kind: str, canvas_hw, min_xy,
                     bands: int, sigma: float, use_seam: bool,
                     use_field: bool, mesh: Mesh, chunk: int = 0):
    """Full-res multiband render with the images split over the ranks:
    each rank folds its contiguous share of the images into a private
    whole-canvas accumulator, in chunks of ``chunk`` images (0: all at
    once), with the single-device stream's per-image work
    (render/fullres._chunk_accum); one reduce_scatter per accumulator sums
    across ranks and leaves each rank a slab of canvas columns to
    normalise; an all_gather assembles the uint8 panorama on every rank.

    ``src_u8``: the (m, Hs, Ws, 3) uint8 sources (numpy or a tensor; each
    rank uploads only its own); the per-image parameters are (m, ...)
    arrays as render/fullres.render_full_dev builds them, the seam and
    field blocks device tensors."""
    from simplepanorama_tpu_torch.render.fullres import _chunk_accum
    H, W = canvas_hw
    out_h, out_w = block_hw
    dev = mesh.device
    m = src_u8.shape[0]
    Hc2 = H + out_h
    Wc2 = pad_leading(W + out_w, mesh.size)
    color = torch.zeros((Hc2, Wc2, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros((Hc2, Wc2), dtype=torch.float32, device=dev)
    lo, hi = shard_range(m, mesh)
    G = chunk if chunk > 0 else max(1, hi - lo)
    T = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    for s in range(lo, hi, G):
        ids = list(range(s, min(s + G, hi)))
        _chunk_accum(
            color, alpha, torch.as_tensor(src_u8[ids], device=dev),
            T(Ka[ids]),
            T(R[ids]), T(corner[ids]), T(vhw[ids]), T(roi_wh[ids]),
            [tuple(int(v) for v in offs[b]) for b in ids],
            seam_blks[ids] if use_seam else None,
            [tuple(map(float, seam_ratios[b])) for b in ids],
            field_blks[ids] if use_field else None,
            [tuple(map(float, field_ratios[b])) for b in ids],
            [float(gains[b]) for b in ids],
            scale=scale, kind=kind, out_h=out_h, out_w=out_w, bands=bands,
            sigma=float(sigma), method="MULTI", use_seam=use_seam,
            use_field=use_field, paste_seam=False)
    color = reduce_scatter_columns(color, mesh)
    alpha = reduce_scatter_columns(alpha, mesh)
    out = torch.clamp(_finish_slab(color, alpha, bands), 0.0, 255.0)
    return all_gather_cat(out.to(torch.uint8), mesh, dim=1)[:H, :W]


def fullres_multi_canvas(src_u8, Ka, R, corner, vhw, roi_wh, offs,
                         seam_blks, seam_ratios, field_blks, field_ratios,
                         gains, scale: float, kind: str, canvas_hw, min_xy,
                         bands: int, sigma: float, use_seam: bool,
                         use_field: bool, mesh: Mesh):
    """Full-res multiband render with the canvas column-sharded (the
    warp_tiled schedule; render/fullres.render_full_dev takes it only when
    asked for): every image is
    warped straight onto each rank's slab of canvas columns, its seam and
    field blocks are upsampled straight into canvas coordinates, and the
    band blurs and the mask erosion run on the slabs with halo exchanges.
    A warped block is the canvas restricted to its ROI, so the per-image
    math is the block schedule's. Arguments as fullres_multi_dp (every
    rank uploads every image, one at a time); the uint8 panorama comes
    back on every rank."""
    from simplepanorama_tpu_torch.render.fullres import _resize_matrix
    H, W = canvas_hw
    dev = mesh.device
    Hcp = (H + 7) // 8 * 8
    Wcp = pad_leading(W, 128 * mesh.size)
    Wsl = Wcp // mesh.size
    x0 = mesh.rank * Wsl
    radius = int(np.ceil(3 * sigma))
    sigmas = _band_sigmas(bands, sigma)
    yy, xx = _slab_grid(Hcp, Wsl, x0, dev)
    origin = torch.tensor([float(min_xy[0]), float(min_xy[1])],
                          dtype=torch.float32, device=dev)
    color = torch.zeros((Hcp, Wsl, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros((Hcp, Wsl), dtype=torch.float32, device=dev)
    T = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    for g in range(src_u8.shape[0]):
        src = torch.as_tensor(src_u8[g], device=dev)
        warped, inb = prj.warp_from_grid_u8(src, T(Ka[g]), T(R[g]), origin,
                                            scale, kind, yy, xx, T(vhw[g]))
        offy, offx = (float(v) for v in offs[g])
        rw, rh = (float(v) for v in roi_wh[g])
        mask = _erode_slab(inb, 4, mesh) & (yy >= offy) & (yy < offy + rh) \
            & (xx >= offx) & (xx < offx + rw)
        mask_f = mask.to(torch.float32)
        if use_seam:
            sb = seam_blks[g]
            Wy = _resize_matrix(Hcp, sb.shape[0], float(seam_ratios[g][0]),
                                offset=-offy, cubic=True, device=dev)
            Wx = _resize_matrix(Wsl, sb.shape[1], float(seam_ratios[g][1]),
                                offset=x0 - offx, cubic=True, device=dev)
            seam = ((Wy @ sb @ Wx.T > 0.5) & mask).to(torch.float32)
        else:
            seam = mask_f
        img = warped / float(gains[g])
        if use_field:
            fb = field_blks[g]
            Wy = _resize_matrix(Hcp, fb.shape[0], float(field_ratios[g][0]),
                                offset=-offy, cubic=False, device=dev)
            Wx = _resize_matrix(Wsl, fb.shape[1], float(field_ratios[g][1]),
                                offset=x0 - offx, cubic=False, device=dev)
            f_up = Wy @ fb @ Wx.T
            f_up = torch.where(torch.abs(f_up) < 1e-6,
                               torch.ones_like(f_up), f_up)
            img = img / f_up[..., None]
        # the multiband contribution on the slab, halo-exchanged blurs
        src4 = torch.cat([img, seam[..., None]], -1)
        blurred = {s: _blur_slab(src4, s, radius, mesh) for s in set(sigmas)}
        for i in range(bands):
            sb_ = sigmas[i]
            if i == bands - 1:
                band = img - blurred[sb_][..., :3]
            elif i > 0:
                band = blurred[sb_][..., :3] - blurred[sigmas[i + 1]][..., :3]
            else:
                band = blurred[sb_][..., :3]
            w = torch.where(mask_f > 0, blurred[sb_][..., 3],
                            torch.zeros_like(mask_f))
            color = color + band * w[..., None]
            alpha = alpha + w
    out = torch.clamp(_finish_slab(color, alpha, bands), 0.0, 255.0)
    return all_gather_cat(out.to(torch.uint8), mesh, dim=1)[:H, :W]
