"""Compositing orchestration and the pipeline run.

Port of simplepanorama_tpu/stitcher.py (pan::stitch_parameters and
panorama::stitch_panorama of the reference).

set_config: optional straightening -> projector with focal = K(0,0) of
the best-connected camera -> warp all connected images -> (stereographic
centre fix) -> optional intensity equalization -> optional gain
compensation -> seam masks (graph cut if ``cut``, else distance-transform
seams for MULTI_BLEND or ``cut_seams``).

get_preview: gain and intensity adjustment, then NO_BLEND pastes (with
cut masks when available), SIMPLE_BLEND feathers the footprints,
MULTI_BLEND blends the seams against the footprints; the stereographic
fix inpaints the centre last.

render_full: the full-resolution re-render, reusing the preview's seams,
intensity fields and gains: streamed through render.fullres, or, for the
stereographic centre fix, which needs a fresh circle estimate over all
full-res masks, through the per-image lists of render_full_host.

The stage entry points run on the card unless the caller asks for
another device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from simplepanorama_tpu_torch.config import Blending, Config, Projection
from simplepanorama_tpu_torch.render import exposure as expo
from simplepanorama_tpu_torch.stitch import StitchResult

_PROJ_KIND = {
    Projection.SPHERICAL: "spherical",
    Projection.CYLINDRICAL: "cylindrical",
    Projection.STEREOGRAPHIC: "stereographic",
}


@dataclasses.dataclass
class StitchParams:
    """Post-BA compositing state (pan::stitch_parameters); the packed
    warped blocks live on the device in ``state``."""
    res: StitchResult
    rot: np.ndarray                 # possibly straightened copy
    proj_kind: str
    scale: float
    state: "object"                 # render.compose.ComposeState
    gains: Optional[np.ndarray] = None
    sten_circle: Optional[tuple] = None   # ((ax, ay), r) inpaint anchor

    # ---- per-image views of the packed blocks (device tensors), for the
    # stereographic fix ----
    def _lists(self):
        st = self.state
        imgs, masks, corners = [], [], []
        for b, (tlx, tly, rw, rh) in enumerate(st.rois):
            imgs.append(st.imgs[b, :rh, :rw])
            masks.append(st.masks[b, :rh, :rw])
            corners.append((tlx, tly))
        return imgs, masks, corners

    @property
    def seam_masks(self):
        if self.state.seam_masks is None:
            return None
        return [self.state.seam_masks[b, :rh, :rw]
                for b, (_, _, rw, rh) in enumerate(self.state.rois)]


def _pack_state(imgs, masks, corners):
    """Repack per-image blocks (tensors on one device) into a ComposeState
    on that device, Hb padded to 8 and Wb to 128 (blending.pack_blocks)."""
    from simplepanorama_tpu_torch.render.blending import pack_blocks
    from simplepanorama_tpu_torch.render.compose import ComposeState
    b_imgs, b_masks, offs, hw = pack_blocks(imgs, masks, corners)
    (tx, ty), (oy, ox) = corners[0], offs[0]
    return ComposeState(
        imgs=b_imgs, masks=b_masks > 0,
        offs=torch.as_tensor(offs, dtype=torch.int32, device=b_imgs.device),
        rois=[(x, y, im.shape[1], im.shape[0])
              for (x, y), im in zip(corners, imgs)],
        canvas_hw=hw, min_xy=(tx - ox, ty - oy))


def set_config(res: StitchResult, images: Sequence[np.ndarray], cfg: Config,
               progress: Optional[Callable[[float], None]] = None,
               cancelled: Optional[Callable[[], bool]] = None,
               dev_images=None, device="cuda") -> StitchParams:
    """images: the component's images (res.nodes order), BGR uint8.
    ``dev_images``: optional (batch_u8, rows) device-resident pixel
    source (see compose.warp_all), rows indexed like ``images``."""
    from simplepanorama_tpu_torch.render import compose, graphcut
    from simplepanorama_tpu_torch.utils.timing import stage
    rot = res.rot.copy()
    if cfg.straighten:
        rot = expo.straighten(rot)
    scale = float(res.K[res.center][0, 0])
    kind = _PROJ_KIND[cfg.proj]

    with stage("warp"):
        state = compose.warp_all(kind, scale, images, list(rot),
                                 list(res.K), list(res.connectivity),
                                 dev_images=dev_images, device=device)
    params = StitchParams(res=res, rot=rot, proj_kind=kind, scale=scale,
                          state=state)
    # the stereographic fix repacks the state, so it runs before the
    # exposure fields and the seams, which then work on the new blocks
    if cfg.fix_center and cfg.proj == Projection.STEREOGRAPHIC:
        from simplepanorama_tpu_torch.render import sten_fix
        with stage("sten_fix"):
            sten_fix.apply_center_fix(params, cfg)
    if cancelled is not None and cancelled():
        raise RuntimeError("Process canceled")

    st = params.state
    if cfg.blend_intensity:
        with stage("equalize"):
            st.intensity = compose.equalize_dev(st.imgs, st.masks, st.offs,
                                                st.canvas_hw)
    if cfg.gain_compensation:
        with stage("gain"):
            params.gains = compose.gain_dev(st.imgs, st.masks, st.offs,
                                            st.canvas_hw, res.adj)
    if cfg.cut:
        seq = [n for n, _ in res.order]
        with stage("graph_cut"):
            if st.imgs.device.type == "cpu":
                # the host loop with the native Dinic solver, as the JAX
                # package runs on its CPU backend
                from simplepanorama_tpu_torch.render.blending import \
                    pad_stack
                imgs_l, masks_l, corners_l = params._lists()
                seams_l = graphcut.graph_cut(
                    imgs_l, masks_l, corners_l, seq, progress=progress,
                    cancelled=cancelled)
                st.seam_masks = pad_stack(seams_l, st.masks.shape[1:],
                                          st.masks.device) > 0
            else:
                # the device chain: the canvas stays resident and each
                # image's cut feeds the next (kernels 1 and 2)
                st.seam_masks = graphcut.graph_cut_state(
                    st, seq, progress=progress, cancelled=cancelled)
    elif cfg.blend == Blending.MULTI_BLEND or cfg.cut_seams:
        with stage("dist_cut"):
            st.seam_masks = compose.dist_cut_dev(st.masks, st.offs,
                                                 st.canvas_hw)
    return params


def render_preview(params: StitchParams, cfg: Config) -> np.ndarray:
    """Preview assembly (stitch_parameters::get_preview)."""
    from simplepanorama_tpu_torch.render import compose
    from simplepanorama_tpu_torch.utils.timing import stage
    with stage("render_preview"):
        st = params.state
        imgs = st.imgs
        if cfg.gain_compensation and params.gains is not None:
            imgs = imgs / torch.as_tensor(params.gains, dtype=torch.float32,
                                          device=imgs.device)[:, None, None,
                                                              None]
        if cfg.blend_intensity and st.intensity is not None:
            imgs = compose.apply_intensity_dev(imgs, st.intensity)
        method = ("NO_BLEND" if cfg.blend == Blending.NO_BLEND else
                  "SIMPLE_BLEND" if cfg.blend == Blending.SIMPLE_BLEND else
                  "MULTI_BLEND")
        if method == "NO_BLEND" and not (cfg.cut or cfg.cut_seams):
            st = dataclasses.replace(st, seam_masks=None)
        out = compose.blend_dev(method, st, imgs, cfg.bands,
                                cfg.sigma_blend)
        if params.sten_circle is not None:
            from simplepanorama_tpu_torch.render import sten_fix
            (ax, ay), r = params.sten_circle
            out = sten_fix.inpaint_center(
                out, (ax - st.min_xy[0], ay - st.min_xy[1]), r)
        return out


def _blend_dispatch(cfg: Config, imgs, masks, seam_masks,
                    corners) -> np.ndarray:
    """Blend per-image lists (stitch_parameters::get_preview's dispatch)
    to the uint8 panorama."""
    from simplepanorama_tpu_torch.render import blending as blnd
    if cfg.blend == Blending.NO_BLEND:
        use_masks = seam_masks if (cfg.cut or cfg.cut_seams) and seam_masks \
            else masks
        out = blnd.blend("NO_BLEND", imgs, use_masks, masks, corners)
    elif cfg.blend == Blending.SIMPLE_BLEND:
        out = blnd.blend("SIMPLE_BLEND", imgs, masks, masks, corners)
    else:
        out = blnd.blend("MULTI_BLEND", imgs, seam_masks, masks, corners,
                         bands=cfg.bands, sigma=cfg.sigma_blend)
    return np.clip(out, 0, 255).astype(np.uint8)


def render_full(params: StitchParams, cfg: Config,
                full_images: Sequence[Optional[np.ndarray]],
                src_stack=None) -> np.ndarray:
    """Full-resolution re-render (stitch_parameters::return_full): rescale
    K by the full/preview resolution ratio, re-project, resize the seam
    masks on the device, re-blend. Streamed through render.fullres, except
    for the stereographic centre fix, which renders the per-image lists
    of render_full_host. ``full_images`` is indexed like the component;
    ``src_stack``, their packed stack already on the device
    (fullres.prefetch_sources), is used by the streamed render and
    ignored by render_full_host."""
    from simplepanorama_tpu_torch.render.fullres import render_full_dev
    from simplepanorama_tpu_torch.utils.timing import stage
    with stage("render_full"):
        if cfg.fix_center and cfg.proj == Projection.STEREOGRAPHIC:
            return render_full_host(params, cfg, full_images)
        return render_full_dev(params, cfg, full_images,
                               src_stack=src_stack)


def render_full_host(params: StitchParams, cfg: Config,
                     full_images: Sequence[Optional[np.ndarray]]
                     ) -> np.ndarray:
    """Full-res render through per-image lists on the device of the
    preview's blocks, with the stereographic centre re-fixed at full
    resolution (return_full, _panorama.cpp:292-311): a fresh circle
    estimate on the full-res masks, disk_reproj of the full-res warp, and
    the inpaint after the blend. render_full calls it only for fix_center
    with STEREOGRAPHIC."""
    from simplepanorama_tpu_torch.config import Stretch
    from simplepanorama_tpu_torch.geometry.canvas import get_pan_dimension
    from simplepanorama_tpu_torch.render import projection as prj
    from simplepanorama_tpu_torch.render import sten_fix
    from simplepanorama_tpu_torch.render.fullres import _upsample_block
    res = params.res
    st = params.state
    dev = st.imgs.device
    K_scaled = np.array(res.K, np.float64)
    for l, img in enumerate(full_images):
        if img is None:
            continue
        r = img.shape[1] / res.sizes[l][1]
        K_scaled[l, 0, 0] *= r
        K_scaled[l, 0, 2] *= r
        K_scaled[l, 1, 1] *= r
        K_scaled[l, 1, 2] *= r
    scale = float(K_scaled[res.center][0, 0])
    imgs_f = [im if im is not None else np.zeros((4, 4, 3), np.uint8)
              for im in full_images]
    pd = prj.get_proj_parameters(
        params.proj_kind, scale, imgs_f, list(params.rot), list(K_scaled),
        list(res.connectivity), device=dev)

    sten_full = None
    est = sten_fix.estimate_circle(pd.masks, pd.corners)
    if est is not None:
        (cx, cy), r = est
        quad = cfg.stretching == Stretch.QUADRATIC_SCALING
        f_imgs, f_masks, f_corners, ansatz = sten_fix.disk_reproj(
            pd.imgs, pd.masks, pd.corners, (cx, cy), r, quad)
        pd = prj.ProjData(imgs=f_imgs, masks=f_masks, corners=f_corners)
        sten_full = (ansatz, r)

    # the preview's seams upsampled (cubic, > 0.5) and its intensity
    # fields (linear) to each full-res block, on the device, with the
    # cv2-aligned matrices of render.fullres
    seam_masks = None
    if params.seam_masks is not None:
        seam_masks = []
        for sm, im in zip(params.seam_masks, pd.imgs):
            h, w = im.shape[:2]
            up = _upsample_block(sm.to(torch.float32), (h, w),
                                 (sm.shape[0] / h, sm.shape[1] / w), True)
            seam_masks.append(up > 0.5)
    imgs = pd.imgs
    if cfg.gain_compensation and params.gains is not None:
        imgs = [im / float(g) for im, g in zip(imgs, params.gains)]
    if cfg.blend_intensity and st.intensity is not None:
        adjusted = []
        for b, (im, (_, _, rw, rh)) in enumerate(zip(imgs, st.rois)):
            h, w = im.shape[:2]
            up = _upsample_block(st.intensity[b, :rh // 2, :rw // 2], (h, w),
                                 ((rh // 2) / h, (rw // 2) / w), False)
            up = torch.where(torch.abs(up) < 1e-6, torch.ones_like(up), up)
            adjusted.append(im / up[..., None])
        imgs = adjusted
    out = _blend_dispatch(cfg, list(imgs), pd.masks, seam_masks, pd.corners)
    if sten_full is not None:
        (ax, ay), r = sten_full
        d = get_pan_dimension(pd.corners,
                              [tuple(im.shape[:2]) for im in pd.imgs])
        out = sten_fix.inpaint_center(out, (ax - d.min_x, ay - d.min_y), r)
    return out


def render_full_from_imageset(params: StitchParams, cfg: Config,
                              images) -> np.ndarray:
    """Full-res render driven by an io.ImageSet (panorama::get_panorama ->
    return_full: full-res decode of only the connected images,
    _image.cpp:76-91)."""
    res = params.res
    connected = [False] * len(images.loaded)
    for g in res.nodes:
        connected[g] = True
    full = images.load_connected_images(connected, cfg.threads)
    return render_full(params, cfg, [full[g] for g in res.nodes])


def run_pipeline(images, cfg: Config, progress=None, cancel_token=None,
                 device="cuda", pair_draws=None):
    """load -> features -> adjacency -> components -> focal -> BA -> warp.

    ``images`` is an io.ImageSet; returns (StitchResult, StitchParams,
    (n_connected, n_total)). Progress weights follow the reference:
    keypoints 1/6, matching 1/6, BA 1/3, seams/warp 1/3. ``pair_draws``
    replaces the RANSAC draw stream (adjacency.build_adjacency)."""
    from simplepanorama_tpu_torch.adjacency import build_adjacency
    from simplepanorama_tpu_torch.features import extract_features
    from simplepanorama_tpu_torch.geometry.focal import focal_from_hom
    from simplepanorama_tpu_torch.geometry.graph import connected_components
    from simplepanorama_tpu_torch.stitch import bundle_adjust_stitching
    from simplepanorama_tpu_torch.utils.timing import stage

    cancelled = cancel_token.cancelled if cancel_token is not None else None

    def prog(delta, text=None):
        if progress is not None:
            progress.add(delta, text)

    if progress is not None:
        progress.set(0.0, "Calculating Keypoints...")
    with stage("load"):
        # streaming decode: the pool starts here and the SIFT chunks take
        # the images as they decode (features._extract_stream), so
        # decode overlaps the device's work instead of running before it
        pending = images.load_resized_stream(cfg.init_size, cfg.threads)
        if pending is not None and images.img_data:
            # mixed state (some images already loaded): materialize
            pending.finalize()
            pending = None
    n_total = len(images.img_data) if pending is None else len(pending)
    if n_total < 2:
        if pending is not None:
            pending.finalize()
        raise RuntimeError("Need at least two images")
    with stage("keypoints"):
        feats = extract_features(
            pending if pending is not None else images.img_data, cfg,
            progress=lambda d: prog(d / 6.0), cancelled=cancelled,
            device=device)      # finalizes the load

    if progress is not None:
        progress.set(1 / 6, "Matching Images...")
    sizes = [im.shape[:2] for im in images.img_data]
    with stage("matching"):
        adjres = build_adjacency(feats, sizes, cfg,
                                 progress=lambda d: prog(d / 6.0),
                                 cancelled=cancelled, pair_draws=pair_draws)

    comp = connected_components(adjres.adj)[0]
    if len(comp.nodes) < 2:
        raise RuntimeError("Images could not be connected")
    focal = focal_from_hom(adjres.hom_mat, adjres.adj)
    if focal <= 0:
        focal = float(cfg.focal)

    if progress is not None:
        progress.set(2 / 6, "Adjusting Panorama...")
    with stage("bundle_adjust"):
        res = bundle_adjust_stitching(comp, adjres, sizes, focal, cfg,
                                      progress=lambda d: prog(d / 3.0),
                                      cancelled=cancelled, device=device)

    if progress is not None:
        progress.set(4 / 6, "Projecting Images...")
    comp_imgs = [images.img_data[g] for g in res.nodes]
    # (in a world of several ranks the pixels stay with the rank that
    # extracted them, and the warp uploads the images)
    dev_images = None if feats.device_images is None else \
        (feats.device_images, list(res.nodes))
    with stage("compositing"):
        params = set_config(res, comp_imgs, cfg,
                            progress=lambda d: prog(d / 3.0),
                            cancelled=cancelled, dev_images=dev_images,
                            device=device)
    if progress is not None:
        progress.set(1.0, "Done")
    return res, params, (len(comp.nodes), n_total)
