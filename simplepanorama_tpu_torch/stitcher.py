"""Compositing orchestration and the pipeline run.

Port of simplepanorama_tpu/stitcher.py (pan::stitch_parameters and
panorama::stitch_panorama of the reference).

set_config: optional straightening -> projector with focal = K(0,0) of
the best-connected camera -> warp all connected images -> optional
intensity equalization -> seam masks (graph cut if ``cut``, else
distance-transform seams for MULTI_BLEND or ``cut_seams``).

get_preview: gain and intensity adjustment, then NO_BLEND pastes (with
cut masks when available), SIMPLE_BLEND feathers the footprints,
MULTI_BLEND blends the seams against the footprints.

render_full: the full-resolution re-render (render.fullres), reusing the
preview's seams, intensity fields and gains.

Not ported yet (raises NotImplementedError naming its ROADMAP item): the
stereographic centre fix.
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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP: port queue, {item})")


def set_config(res: StitchResult, images: Sequence[np.ndarray], cfg: Config,
               progress: Optional[Callable[[float], None]] = None,
               cancelled: Optional[Callable[[], bool]] = None,
               dev_images=None, device="cpu") -> StitchParams:
    """images: the component's images (res.nodes order), BGR uint8.
    ``dev_images``: optional (batch_u8, rows) device-resident pixel
    source (see compose.warp_all), rows indexed like ``images``."""
    from simplepanorama_tpu_torch.render import compose, graphcut
    from simplepanorama_tpu_torch.utils.timing import stage
    if cfg.fix_center and cfg.proj == Projection.STEREOGRAPHIC:
        raise _not_ported("the stereographic centre fix",
                          "other projections and extras")
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
            # the device chain on every device: the canvas stays resident
            # and each image's cut feeds the next
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
        return compose.blend_dev(method, st, imgs, cfg.bands,
                                 cfg.sigma_blend)


def render_full(params: StitchParams, cfg: Config,
                full_images: Sequence[Optional[np.ndarray]]) -> np.ndarray:
    """Full-resolution re-render (stitch_parameters::return_full): rescale
    K by the full/preview resolution ratio, re-project, resize the seam
    masks on the device, re-blend, streamed through render.fullres.
    ``full_images`` is indexed like the component."""
    if cfg.fix_center and cfg.proj == Projection.STEREOGRAPHIC:
        raise _not_ported("the stereographic centre fix",
                          "other projections and extras")
    from simplepanorama_tpu_torch.render.fullres import render_full_dev
    from simplepanorama_tpu_torch.utils.timing import stage
    with stage("render_full"):
        return render_full_dev(params, cfg, full_images)


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
                 device="cpu", pair_draws=None):
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
        images.load_resized(cfg.init_size, cfg.threads)
    n_total = len(images.img_data)
    if n_total < 2:
        raise RuntimeError("Need at least two images")
    with stage("keypoints"):
        feats = extract_features(images.img_data, cfg,
                                 progress=lambda d: prog(d / 6.0),
                                 cancelled=cancelled, device=device)

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
    dev_images = (feats.device_images, list(res.nodes))
    with stage("compositing"):
        params = set_config(res, comp_imgs, cfg,
                            progress=lambda d: prog(d / 3.0),
                            cancelled=cancelled, dev_images=dev_images,
                            device=device)
    if progress is not None:
        progress.set(1.0, "Done")
    return res, params, (len(comp.nodes), n_total)
