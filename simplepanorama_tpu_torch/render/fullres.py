"""Full-resolution render on one device, streamed in chunks.

Port of the single-device path of simplepanorama_tpu/render/fullres.py
(the reference's return_full, _panorama.cpp:259-354): reload the
full-resolution images, rescale K by the full/preview width ratio,
re-project, upsample the preview's seam masks and intensity fields to the
full-res blocks, divide by the preview's gains, and re-blend. BA never
runs again.

The only persistent device state is the canvas accumulator pair (color,
alpha), and the packed source stack when ``prefetch_sources`` uploaded it
ahead of the render (Panorama does so in a background thread while the
preview composites); the images go through in chunks sized to a
device-memory budget, each warped, corrected and folded into the canvas,
then freed. On the card every source upload is from pinned host memory
on a side stream, the next chunk's under the current one's work. Seam masks
are upsampled with a cv2-aligned cubic interpolation matrix (Keys
a=-0.75, pixel-centre mapping src = (dst + 0.5) * ratio - 0.5, the
INTER_CUBIC of _panorama.cpp:329-335), intensity fields with the linear
one (test::adjust_intensity, _test.cpp:110-122).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from simplepanorama_tpu_torch.config import Blending, Config
from simplepanorama_tpu_torch.geometry.canvas import get_pan_dimension
from simplepanorama_tpu_torch.ops.edt import distance_transform
from simplepanorama_tpu_torch.render import projection as prj
from simplepanorama_tpu_torch.render.blending import (_acc_add,
                                                      mb_batch_contribution)

# device-memory budget for in-flight chunk blocks (bytes); the canvas
# accumulators are excluded (they are the irreducible state)
_CHUNK_BUDGET = int(1.5e9)


def _cubic_kernel(t: torch.Tensor) -> torch.Tensor:
    """Keys bicubic, a = -0.75 (OpenCV's INTER_CUBIC)."""
    a = -0.75
    at = torch.abs(t)
    w1 = ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
    w2 = a * (((at - 5.0) * at + 8.0) * at - 4.0)
    return torch.where(at <= 1.0, w1,
                       torch.where(at < 2.0, w2, torch.zeros_like(at)))


def _linear_kernel(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _resize_matrix(n_out: int, n_in: int, ratio: float, offset: float = 0.0,
                   cubic: bool = True, device="cpu") -> torch.Tensor:
    """(n_out, n_in) interpolation matrix with cv2 pixel-centre mapping
    src = (dst + 0.5 + offset) * ratio - 0.5, in float32. Rows are
    normalised (the out-of-range tail of the kernel is redistributed,
    approximating BORDER_REPLICATE); rows whose support misses [0, n_in)
    are zero, and those zero rows are what ends a seam at the edge of its
    block."""
    o = torch.arange(n_out, dtype=torch.float32, device=device)
    r = torch.tensor(ratio, dtype=torch.float32, device=device)
    src = (o + 0.5 + offset) * r - 0.5
    i = torch.arange(n_in, dtype=torch.float32, device=device)
    W = (_cubic_kernel if cubic else _linear_kernel)(src[:, None] - i[None, :])
    s = W.sum(dim=1, keepdim=True)
    return torch.where(torch.abs(s) > 1e-6,
                       W / torch.where(s == 0, torch.ones_like(s), s),
                       torch.zeros_like(W))


def _upsample_block(block: torch.Tensor, n_out_hw, ratio_hw,
                    cubic: bool) -> torch.Tensor:
    """Resize a (h_in, w_in) block to ``n_out_hw`` with per-axis ratios,
    as two matrix products."""
    Wy = _resize_matrix(n_out_hw[0], block.shape[0], ratio_hw[0],
                        cubic=cubic, device=block.device)
    Wx = _resize_matrix(n_out_hw[1], block.shape[1], ratio_hw[1],
                        cubic=cubic, device=block.device)
    return Wy @ block @ Wx.T


def _chunk_accum(color, alpha, src_u8, Ka, R, corner, vhw, roi_wh, offs,
                 seam_blks, seam_ratios, field_blks, field_ratios, gains,
                 scale: float, kind: str, out_h: int, out_w: int,
                 bands: int, sigma: float, method: str, use_seam: bool,
                 use_field: bool, paste_seam: bool) -> None:
    """Fold one chunk of G images into the canvas accumulators, in place
    (port of fullres._chunk_accum).

    method MULTI: (color, alpha) are the multiband sums.
    method SIMPLE: feathered (1 - acc) compositing, as blending.simple_blend.
    method NO: color is the canvas, alpha unused (paste in order).

    src_u8 is the (G, Hs, Ws, 3) uint8 source stack on the device; the
    per-image parameters are (G, ...) tensors on the device (``offs`` host
    (y, x) pairs, ``seam_ratios``/``field_ratios``/``gains`` host floats).
    The chunk may be shorter than the budget's G: the JAX package pads it
    with entries whose source size is 0, which contribute nothing."""
    G = src_u8.shape[0]
    imgs, masks, seam_ups = [], [], []
    for g in range(G):
        # the bilinear warp of the uint8 source (projection.
        # warp_from_grid_u8 computes the same on packed neighbours)
        warped, mask = prj.warp_backward(
            src_u8[g].to(torch.float32), Ka[g], R[g], corner[g], scale, kind,
            out_h, out_w, vhw[g])
        if use_seam:
            seam_ups.append(_upsample_block(seam_blks[g], (out_h, out_w),
                                            seam_ratios[g], cubic=True))
        img = warped / gains[g]
        if use_field:
            f_up = _upsample_block(field_blks[g], (out_h, out_w),
                                   field_ratios[g], cubic=False)
            f_up = torch.where(torch.abs(f_up) < 1e-6,
                               torch.ones_like(f_up), f_up)
            img = img / f_up[..., None]
        # img is NOT zeroed outside the eroded mask: the reference blurs
        # the full warped block (values in the erosion rim bleed into the
        # band colours); the weights alone are mask-gated
        imgs.append(img)
        masks.append(mask)
    imgs = torch.stack(imgs)
    masks = prj.erode_mask(torch.stack(masks), iters=4)
    yy = torch.arange(out_h, device=masks.device)[None, :, None]
    xx = torch.arange(out_w, device=masks.device)[None, None, :]
    masks = masks & (yy < roi_wh[:, 1, None, None]) \
        & (xx < roi_wh[:, 0, None, None])
    masks_f = masks.to(torch.float32)
    if use_seam:
        seams = ((torch.stack(seam_ups) > 0.5) & masks).to(torch.float32)
    else:
        seams = masks_f

    if method == "MULTI":
        colors, alphas = mb_batch_contribution(imgs, seams, masks_f, bands,
                                               sigma)
        for g, off in enumerate(offs):
            _acc_add(color, colors[g], off)
            _acc_add(alpha, alphas[g], off)
    elif method == "SIMPLE":
        dts = distance_transform(masks_f > 0)
        feas = dts / torch.clamp(dts.amax(dim=(1, 2), keepdim=True),
                                 min=1e-12)
        for g, (y, x) in enumerate(offs):
            acc_a = alpha[y:y + out_h, x:x + out_w]
            contrib = feas[g] * (1.0 - acc_a)
            _acc_add(color, imgs[g] * contrib[..., None], (y, x))
            alpha[y:y + out_h, x:x + out_w] = acc_a + contrib
    else:
        sel = seams if paste_seam else masks_f
        for g, (y, x) in enumerate(offs):
            sl = color[y:y + out_h, x:x + out_w]
            color[y:y + out_h, x:x + out_w] = torch.where(
                sel[g][..., None] > 0, imgs[g], sl)


def _finalize(color, alpha, method: str, bands: int, hw) -> torch.Tensor:
    H, W = hw
    color = color[:H, :W]
    alpha = alpha[:H, :W, None]
    if method == "NO":
        out = color
    else:
        out = color / torch.clamp(alpha, min=1e-12)
        if method == "MULTI":
            out = out * bands
        out = torch.where(alpha > 0, out, torch.zeros_like(out))
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def _pad_align(h: int, w: int):
    return (h + 7) // 8 * 8, (w + 127) // 128 * 128


def _host_stack(full_images, ids, Hs: int, Ws: int,
                pinned: bool) -> torch.Tensor:
    """The images ``ids`` of ``full_images`` packed into one (len(ids), Hs,
    Ws, 3) uint8 host tensor, zero-padded at the bottom and right, in
    pinned memory when ``pinned`` (for an asynchronous copy to the
    card)."""
    out = torch.empty((len(ids), Hs, Ws, 3), dtype=torch.uint8,
                      pin_memory=pinned)
    a = out.numpy()
    for k, i in enumerate(ids):
        im = full_images[i]
        h, w = im.shape[:2]
        a[k, :h, :w] = im
        a[k, h:] = 0
        a[k, :h, w:] = 0
    return out


def _send(full_images, ids, Hs: int, Ws: int, dev, side):
    """Pack the images ``ids`` into pinned host memory and queue their
    copy to the card ``dev`` on the stream ``side``. Returns (the stack
    on ``dev``, an event recorded after the copy)."""
    host = _host_stack(full_images, ids, Hs, Ws, True)
    with torch.cuda.stream(side):
        stack = host.to(dev, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(side)
    return stack, ready


def _receive(stack, ready, dev):
    """``stack`` for work on the current stream of ``dev``: the stream
    waits on the copy's event, and the stack is recorded on it so the
    caching allocator does not reuse the block before that work ends."""
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(ready)
    stack.record_stream(consumer)
    return stack


def _chunk_sources(full_images, sel, G: int, Hs: int, Ws: int, dev):
    """The packed sources of ``sel`` on ``dev``, one (<= G, Hs, Ws, 3)
    uint8 stack a chunk, in order. On the card each is copied from pinned
    memory on a side stream, and the next chunk's copy is queued before
    this one is handed out, so that it runs under this chunk's work."""
    spans = [sel[s:s + G] for s in range(0, len(sel), G)]
    if torch.device(dev).type != "cuda":
        for ids in spans:
            yield _host_stack(full_images, ids, Hs, Ws, False).to(dev)
        return
    side = torch.cuda.Stream(dev)
    nxt = _send(full_images, spans[0], Hs, Ws, dev, side)
    for k in range(len(spans)):
        stack, ready = nxt
        if k + 1 < len(spans):
            nxt = _send(full_images, spans[k + 1], Hs, Ws, dev, side)
        yield _receive(stack, ready, dev)


def _selected(params, full_images):
    """The component rows the full-res render draws (connected, with a
    full-res image), and the padded source size (Hs, Ws)."""
    res = params.res
    sel = [i for i in range(len(res.nodes))
           if res.connectivity[i] > 0 and full_images[i] is not None]
    if not sel:
        return sel, (0, 0)
    return sel, (max(full_images[i].shape[0] for i in sel),
                 max(full_images[i].shape[1] for i in sel))


def prefetch_sources(params, full_images: Sequence[Optional[np.ndarray]]
                     ) -> Optional[torch.Tensor]:
    """Upload the packed full-res source stack ahead of render_full_dev,
    on the device of the preview's blocks (``params.state.imgs``): the
    (m, Hs, Ws, 3) uint8 sources of the connected images, zero-padded, in
    component order (None when there are none). Pass it as
    ``src_stack``. The sources depend only on the stitch result, never on
    the compositing config, so a prefetched stack stays valid across
    blend, seam and projection changes.

    On the card the stack is packed into pinned host memory and copied
    with ``non_blocking`` on a side stream; the calling thread's current
    stream waits on the copy's event, and the stack is recorded on that
    stream for the caching allocator, so the call returns before the copy
    lands and work queued on that stream afterwards sees the whole
    stack."""
    sel, (Hs, Ws) = _selected(params, full_images)
    if not sel:
        return None
    dev = params.state.imgs.device
    if dev.type != "cuda":
        return _host_stack(full_images, sel, Hs, Ws, False).to(dev)
    return _receive(*_send(full_images, sel, Hs, Ws, dev,
                           torch.cuda.Stream(dev)), dev)


def render_full_dev(params, cfg: Config,
                    full_images: Sequence[Optional[np.ndarray]],
                    mesh=None, schedule: Optional[str] = None,
                    src_stack: Optional[torch.Tensor] = None) -> np.ndarray:
    """Streaming re-render at full resolution on the device of the
    preview's blocks (port of fullres.render_full_dev).

    ``params`` is the preview StitchParams (seam masks, intensity fields
    and gains are reused at full resolution, per return_full);
    ``full_images`` the full-res BGR uint8 images in component order.

    MULTI_BLEND over a mesh (``mesh``, by default
    parallel.mesh.pipeline_mesh(), None at one rank) takes a
    schedule of parallel/tiled_compose.py: the images split over the ranks
    (``schedule`` "dp", the default when there are at least as many
    images as ranks) or the canvas ("canvas", only when asked for: at one
    rank on an H100 it took 2.7 times the single-device render's wall and
    peak memory). With fewer images than ranks and no ``schedule``, every
    rank renders the whole panorama itself. NO_BLEND and SIMPLE_BLEND
    composite in order and stay single-device."""
    res = params.res
    st = params.state
    dev = st.imgs.device
    n = len(res.nodes)

    # K rescale by the per-image width ratio (_panorama.cpp:272-288)
    K_scaled = np.array(res.K, np.float64)
    sizes_full = []
    for l in range(n):
        img = full_images[l]
        if img is None:
            sizes_full.append(tuple(res.sizes[l]))
            continue
        h0, w0 = res.sizes[l]
        h1, w1 = img.shape[:2]
        r = w1 / w0
        K_scaled[l, 0, 0] *= r
        K_scaled[l, 0, 2] *= r
        K_scaled[l, 1, 1] *= r
        K_scaled[l, 1, 2] *= r
        sizes_full.append((h1, w1))
    scale = float(K_scaled[res.center][0, 0])

    sel, (Hs, Ws) = _selected(params, full_images)
    kind = params.proj_kind

    rois_f = {i: prj.roi_for_image(kind, scale, params.rot[i], K_scaled[i],
                                   sizes_full[i][0], sizes_full[i][1])
              for i in sel}
    out_h, out_w = _pad_align(max(rois_f[i][3] for i in sel),
                              max(rois_f[i][2] for i in sel))
    d = get_pan_dimension([(rois_f[i][0], rois_f[i][1]) for i in sel],
                          [(rois_f[i][3], rois_f[i][2]) for i in sel])

    method = ("NO" if cfg.blend == Blending.NO_BLEND else
              "SIMPLE" if cfg.blend == Blending.SIMPLE_BLEND else "MULTI")
    have_seams = st.seam_masks is not None
    paste_seam = (method == "NO" and have_seams
                  and (cfg.cut or cfg.cut_seams))
    use_seam = (method == "MULTI" and have_seams) or paste_seam
    use_field = cfg.blend_intensity and st.intensity is not None

    # state row of each selected image (warp_all packs connectivity > 0
    # rows in index order, matching the preview blocks)
    state_sel = [i for i in range(n) if res.connectivity[i] > 0]
    row_of = {i: b for b, i in enumerate(state_sel)}

    m = len(sel)
    if src_stack is not None and tuple(src_stack.shape) != (m, Hs, Ws, 3):
        src_stack = None                 # stale prefetch: pack again
    Ka_b = np.zeros((m, 3, 3), np.float32)
    R_b = np.zeros((m, 3, 3), np.float32)
    c_b = np.zeros((m, 2), np.float32)
    vhw_b = np.zeros((m, 2), np.int32)
    wh_b = np.zeros((m, 2), np.int32)
    off_b = []
    sr_b = np.ones((m, 2), np.float32)     # seam (preview -> full) ratios
    fr_b = np.ones((m, 2), np.float32)     # intensity-field ratios
    g_b = np.ones((m,), np.float32)
    for b, i in enumerate(sel):
        h1, w1 = sizes_full[i]
        Ka_b[b] = prj.adjusted_K(K_scaled[i], h1, w1)
        R_b[b] = np.asarray(params.rot[i], np.float32)
        tlx, tly, rw_f, rh_f = rois_f[i]
        c_b[b] = (tlx, tly)
        vhw_b[b] = (h1, w1)
        wh_b[b] = (rw_f, rh_f)
        off_b.append((tly - d.min_y, tlx - d.min_x))
        _, _, rw_p, rh_p = st.rois[row_of[i]]
        sr_b[b] = (rh_p / rh_f, rw_p / rw_f)
        fr_b[b] = ((rh_p // 2) / rh_f, (rw_p // 2) / rw_f)
        if params.gains is not None and cfg.gain_compensation:
            g_b[b] = float(params.gains[row_of[i]])

    # the JAX package's budget (fullres.py:443-457): MULTI holds every
    # band level of the 4-channel blurred batch at once (~16*(bands+1)
    # B/px) on top of the 16 B/px source concat; NO/SIMPLE stay near the
    # flat 12 B/px estimate
    temps = 4 * (4 * (cfg.bands + 1) + 4) if method == "MULTI" else 4 * 12
    per_img = (Hs * Ws * (3 + 16)               # uint8 source + working copy
               + out_h * out_w * 4 * (3 + 1 + 1)    # block + mask + seam
               + out_h * out_w * temps)         # blur/contribution temps
    # a prefetched stack on the device counts against the budget
    budget = _CHUNK_BUDGET - (0 if src_stack is None else src_stack.numel())
    G = int(max(1, min(m, max(1, budget) // max(1, per_img))))

    if method != "MULTI":
        mesh = None
    elif mesh is None:
        from simplepanorama_tpu_torch.parallel.mesh import pipeline_mesh
        mesh = pipeline_mesh()
    if mesh is not None and schedule is None and m < mesh.size:
        mesh = None
    if mesh is not None:
        from simplepanorama_tpu_torch.parallel import tiled_compose as tc
        rows = [row_of[i] for i in sel]
        zeros = torch.zeros((m, 1, 1), dtype=torch.float32, device=dev)
        src = src_stack if src_stack is not None else \
            _host_stack(full_images, sel, Hs, Ws, False)
        args = dict(
            Ka=Ka_b, R=R_b, corner=c_b, vhw=vhw_b, roi_wh=wh_b,
            offs=np.asarray(off_b, np.int64),
            seam_blks=(st.seam_masks[rows].to(torch.float32) if use_seam
                       else zeros),
            seam_ratios=sr_b,
            field_blks=st.intensity[rows] if use_field else zeros,
            field_ratios=fr_b, gains=g_b, scale=scale, kind=kind,
            canvas_hw=(d.height, d.width), min_xy=(d.min_x, d.min_y),
            bands=cfg.bands, sigma=float(cfg.sigma_blend),
            use_seam=use_seam, use_field=use_field, mesh=mesh)
        if schedule in (None, "dp"):
            out = tc.fullres_multi_dp(src, (out_h, out_w), chunk=G, **args)
        elif schedule == "canvas":
            out = tc.fullres_multi_canvas(src, **args)
        else:
            raise ValueError(f"unknown full-res schedule {schedule!r}")
        return out.cpu().numpy()

    if src_stack is None and m >= 4:
        # at least two chunks, so that the next chunk's upload overlaps
        # this one's work (the JAX package's rule)
        G = min(G, (m + 1) // 2)
    color = torch.zeros((d.height + out_h, d.width + out_w, 3),
                        dtype=torch.float32, device=dev)
    alpha = torch.zeros((d.height + out_h, d.width + out_w),
                        dtype=torch.float32, device=dev)
    T = lambda a: torch.as_tensor(a, device=dev)
    sources = (src_stack[s:s + G] for s in range(0, m, G)) \
        if src_stack is not None else \
        _chunk_sources(full_images, sel, G, Hs, Ws, dev)
    for s, src in zip(range(0, m, G), sources):
        ids = list(range(s, min(s + G, m)))
        rows = [row_of[sel[b]] for b in ids]
        _chunk_accum(
            color, alpha, src, T(Ka_b[ids]), T(R_b[ids]), T(c_b[ids]),
            T(vhw_b[ids]), T(wh_b[ids]), [off_b[b] for b in ids],
            st.seam_masks[rows].to(torch.float32) if use_seam else None,
            [tuple(map(float, sr_b[b])) for b in ids],
            st.intensity[rows] if use_field else None,
            [tuple(map(float, fr_b[b])) for b in ids],
            [float(g_b[b]) for b in ids],
            scale=scale, kind=kind, out_h=out_h, out_w=out_w,
            bands=cfg.bands, sigma=float(cfg.sigma_blend), method=method,
            use_seam=use_seam, use_field=use_field, paste_seam=paste_seam)

    return _finalize(color, alpha, method, cfg.bands,
                     (d.height, d.width)).cpu().numpy()
