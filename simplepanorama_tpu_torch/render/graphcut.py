"""Graph-cut seam finding (Kwatra et al., Graphcut Textures).

Port of the device chain of simplepanorama_tpu/render/graphcut.py
(gcut::graph_cut of the reference): incremental compositing in BA
insertion order — paste the first image; for each next image, cut the
overlap between the grayscale canvas built so far and the new image;
finally a mutual-exclusion pass gives each pixel to the latest covering
image.

Per-pair cut graph (computeCut):
  nodes    = overlap pixels (scene mask and element mask);
  edges    = 4-neighbourhood, capacity (|I1-I2|(p) + |I1-I2|(q)) / (sum
             of |Scharr| gradients + eps), horizontal edges from
             y-gradients, vertical edges from x-gradients;
  t-links  = weight 5000 on the scene-mask contour (source) and on the
             element-mask contour (sink), restricted to the overlap.

Two incremental loops, as in the JAX package:
  * ``graph_cut_state``, the device chain over the packed blocks: the
    canvas and scene mask stay on the device and are updated in place,
    image after image; every cut goes to ops.maxflow.grid_mincut_auto
    (kernels 1 and 2 on the card), which solves a block over 1.2M cells
    on its node box, the overlap band. stitcher.set_config takes it on
    the card.
  * ``graph_cut``, the per-image host loop over the per-image crops, which
    set_config takes on the CPU; its ``_solve_cut`` picks the solver: the
    native Dinic (native.py) for CPU tensors (the plain solver where it
    cannot be built), else grid_mincut_auto. In a
    world of several ranks every rank holds the whole graph and solves it
    itself: the column-sharded solver (parallel/dist_mincut.py) runs the
    plain push-relabel's arithmetic as PyTorch ops, far slower than
    kernels 1 and 2, so the seam finder never takes it.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simplepanorama_tpu_torch.geometry.canvas import get_pan_dimension
from simplepanorama_tpu_torch.ops.maxflow import grid_mincut, grid_mincut_auto
from simplepanorama_tpu_torch.utils.timing import span

_SEED_W = 5000.0
_EPS = 1e-6


def _scharr(img: torch.Tensor):
    """OpenCV Scharr 3x3 gradients (x, y) of a (H, W) image, zero border,
    as shifted sums with integer weights (a cross-correlation, like the
    JAX conv)."""
    P = F.pad(img, (1, 1, 1, 1))
    gx = (3.0 * (P[:-2, 2:] - P[:-2, :-2]) + 10.0 * (P[1:-1, 2:] - P[1:-1, :-2])
          + 3.0 * (P[2:, 2:] - P[2:, :-2]))
    gy = (3.0 * (P[2:, :-2] - P[:-2, :-2]) + 10.0 * (P[2:, 1:-1] - P[:-2, 1:-1])
          + 3.0 * (P[2:, 2:] - P[:-2, 2:]))
    return gx, gy


def _boundary(mask: torch.Tensor) -> torch.Tensor:
    """Mask boundary (findContours/drawContours thickness-1 equivalent):
    foreground pixels with a background 8-neighbour or on the border."""
    m = mask.to(torch.float32)
    P = F.pad(m[None, None], (1, 1, 1, 1), value=1.0)
    mn = -F.max_pool2d(-P, 3, stride=1)[0, 0]
    mn[0, :] = 0.0
    mn[-1, :] = 0.0
    mn[:, 0] = 0.0
    mn[:, -1] = 0.0
    return (m > 0) & (mn <= 0)


def _build_cut_graph(img1: torch.Tensor, img2: torch.Tensor,
                     mask1: torch.Tensor, mask2: torch.Tensor):
    """Edge weights + seeds of one seam cut; inputs (H, W), 0..255 scale.
    Returns (cap_h, cap_v, excess, node)."""
    obj = (mask1 > 0) & (mask2 > 0)
    A = torch.abs(img1 - img2)
    g1x, g1y = _scharr(img1)
    g2x, g2y = _scharr(img2)

    def nb(x, dy, dx):
        return torch.roll(x, (-dy, -dx), dims=(0, 1))

    a1y, a2y = torch.abs(g1y), torch.abs(g2y)
    a1x, a2x = torch.abs(g1x), torch.abs(g2x)
    # horizontal edge (y,x)-(y,x+1): y-gradients; vertical: x-gradients
    wh = (A + nb(A, 0, 1)) / (a1y + nb(a1y, 0, 1) + a2y + nb(a2y, 0, 1) + _EPS)
    wv = (A + nb(A, 1, 0)) / (a1x + nb(a1x, 1, 0) + a2x + nb(a2x, 1, 0) + _EPS)

    cont_scene = _boundary(mask1) & obj
    cont_elem = _boundary(mask2) & obj
    excess = _SEED_W * cont_scene.to(torch.float32) \
        - _SEED_W * (cont_elem & ~cont_scene).to(torch.float32)
    return wh, wv, excess, obj


def _solve_cut(wh, wv, excess, obj, mask2):
    """Min-cut dispatch (the JAX package's _solve_cut): the native Dinic
    solver for CPU tensors (the reference's BK slot), else
    grid_mincut_auto (kernel 1 or 2 on the card), in a world of any size.
    Where the native solver cannot be built (native.NativeUnavailable),
    a CPU cut takes the plain solver (grid_mincut on the CPU tensors,
    ops/maxflow.grid_mincut_ref) and the process warns once: the JAX
    package falls back to its own solver on any error of the native one,
    the port on a failed build alone. Returns the element's cut mask:
    the source side on the overlap, ``mask2`` elsewhere."""
    if wh.device.type == "cpu":
        from simplepanorama_tpu_torch import native
        try:
            side = torch.from_numpy(
                native.grid_mincut_native(wh, wv, excess, obj)[0])
        except native.NativeUnavailable as e:
            _warn_native_unavailable(e)
            side = grid_mincut(wh, wv, excess, obj)
    else:
        with span("seams.solve"):
            side = grid_mincut_auto(wh, wv, excess, obj)
    return torch.where(obj, side, mask2 > 0)


# set at the first warning: one warning per process (two threads that
# race on it may both warn, which does no harm)
_NATIVE_WARNED = False


def _warn_native_unavailable(err: Exception) -> None:
    """Warn, once per process, that CPU cuts take the plain solver."""
    global _NATIVE_WARNED
    if not _NATIVE_WARNED:
        _NATIVE_WARNED = True
        warnings.warn(f"the native min-cut solver is unavailable, CPU seams "
                      f"take the plain solver (ops/maxflow.grid_mincut_ref)"
                      f": {err}", RuntimeWarning, stacklevel=3)


def graph_cut(images: Sequence, masks: Sequence,
              corners: Sequence[Tuple[int, int]], seq: Sequence[int],
              progress: Optional[Callable[[float], None]] = None,
              cancelled: Optional[Callable[[], bool]] = None,
              ) -> List[torch.Tensor]:
    """Incremental graph-cut seams over the component's per-image crops
    (the JAX package's host loop): ``images`` (h_i, w_i, 3) on the 0..255
    scale and ``masks`` (h_i, w_i), tensors on one device or numpy (the
    CPU), ``corners`` their (tl_x, tl_y), ``seq`` the BA insertion order.
    One solve per image after the first (_solve_cut), each read back
    before the next. Returns one bool seam mask per image, same shapes,
    on the images' device."""
    dev = images[0].device if torch.is_tensor(images[0]) else \
        torch.device("cpu")
    T = lambda a: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                  else a, device=dev)
    sizes = [tuple(im.shape[:2]) for im in images]
    d = get_pan_dimension(corners, sizes)
    pano = torch.zeros((d.height, d.width), dtype=torch.float32, device=dev)
    scene = torch.zeros((d.height, d.width), dtype=torch.bool, device=dev)
    grays = [_gray_batch(T(im).to(torch.float32)) for im in images]
    rois = [(ty - d.min_y, tx - d.min_x) for tx, ty in corners]
    out = [T(m) > 0 for m in masks]

    first = seq[0]
    (y0, x0), (h, w) = rois[first], sizes[first]
    m0 = out[first]
    pano[y0:y0 + h, x0:x0 + w] = torch.where(m0, grays[first],
                                             pano[y0:y0 + h, x0:x0 + w])
    scene[y0:y0 + h, x0:x0 + w] |= m0
    n = max(1, len(seq) - 1)
    for s in seq[1:]:
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        (y0, x0), (h, w) = rois[s], sizes[s]
        pano_roi = pano[y0:y0 + h, x0:x0 + w]
        scene_roi = scene[y0:y0 + h, x0:x0 + w]
        m2 = out[s].to(torch.float32) * 255.0
        cut = _solve_cut(*_build_cut_graph(
            pano_roi, grays[s], scene_roi.to(torch.float32) * 255.0, m2), m2)
        out[s] = cut
        pano[y0:y0 + h, x0:x0 + w] = torch.where(cut, grays[s], pano_roi)
        scene[y0:y0 + h, x0:x0 + w] = scene_roi | cut
        if progress is not None:
            progress(1.0 / n)

    # mutual exclusion: ownership by the latest covering image in seq
    owner = torch.full((d.height, d.width), -1, dtype=torch.int64,
                       device=dev)
    for s in seq:
        (y0, x0), (h, w) = rois[s], sizes[s]
        region = owner[y0:y0 + h, x0:x0 + w]
        region[out[s]] = s
    for s in seq:
        (y0, x0), (h, w) = rois[s], sizes[s]
        out[s] = out[s] & (owner[y0:y0 + h, x0:x0 + w] == s)
    return out


def _cut_step(canvas_g, scene, gray_b, mask_b, off: Tuple[int, int]):
    """One incremental cut over padded blocks: slice the canvas under the
    new image, build the seam graph, solve, paste (canvas and scene are
    updated in place). Returns the image's cut mask."""
    Hb, Wb = gray_b.shape
    y, x = off
    pano_roi = canvas_g[y:y + Hb, x:x + Wb]
    scene_roi = scene[y:y + Hb, x:x + Wb]
    wh, wv, excess, obj = _build_cut_graph(
        pano_roi, gray_b, scene_roi.to(torch.float32) * 255.0,
        mask_b.to(torch.float32) * 255.0)
    with span("seams.solve"):
        side = grid_mincut_auto(wh, wv, excess, obj)
    cut = torch.where(obj, side, mask_b)
    canvas_g[y:y + Hb, x:x + Wb] = torch.where(cut, gray_b, pano_roi)
    scene[y:y + Hb, x:x + Wb] = scene_roi | cut
    return cut


def _paste_first(canvas_g, scene, gray_b, mask_b, off: Tuple[int, int]):
    Hb, Wb = gray_b.shape
    y, x = off
    pano_roi = canvas_g[y:y + Hb, x:x + Wb]
    canvas_g[y:y + Hb, x:x + Wb] = torch.where(mask_b, gray_b, pano_roi)
    scene[y:y + Hb, x:x + Wb] |= mask_b


def _mutual_exclusion_dev(cuts: torch.Tensor, offs: Sequence[Tuple[int, int]],
                          seq: Sequence[int], canvas_hw: Tuple[int, int]):
    """Ownership by the latest covering image in ``seq`` (the reference's
    mask-exclusion pass, _graph_cut.cpp:84-115)."""
    N, Hb, Wb = cuts.shape
    H, W = canvas_hw
    owner = torch.full((H + Hb, W + Wb), -1, dtype=torch.int32,
                       device=cuts.device)
    for s in seq:
        y, x = offs[s]
        region = owner[y:y + Hb, x:x + Wb]
        region[cuts[s]] = s
    outs = []
    for s in range(N):
        y, x = offs[s]
        outs.append(cuts[s] & (owner[y:y + Hb, x:x + Wb] == s))
    return torch.stack(outs)


def graph_cut_state(state, seq: Sequence[int],
                    progress: Optional[Callable[[float], None]] = None,
                    cancelled: Optional[Callable[[], bool]] = None):
    """Incremental graph-cut seams on a ComposeState's packed blocks.
    Returns the (N, Hb, Wb) bool seam-mask batch on the blocks' device."""
    imgs, masks = state.imgs, state.masks
    offs = [tuple(o) for o in state.offs.tolist()]
    H, W = state.canvas_hw
    N, Hb, Wb = masks.shape
    gray = _gray_batch(imgs)
    canvas_g = torch.zeros((H + Hb, W + Wb), dtype=torch.float32,
                           device=imgs.device)
    scene = torch.zeros((H + Hb, W + Wb), dtype=torch.bool,
                        device=imgs.device)

    outs: List = [None] * N
    first = seq[0]
    _paste_first(canvas_g, scene, gray[first], masks[first], offs[first])
    outs[first] = masks[first]
    n = max(1, len(seq) - 1)
    for s in seq[1:]:
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        outs[s] = _cut_step(canvas_g, scene, gray[s], masks[s], offs[s])
        if progress is not None:
            progress(1.0 / n)
    return _mutual_exclusion_dev(torch.stack(outs), offs, tuple(seq), (H, W))


def _gray_batch(imgs: torch.Tensor) -> torch.Tensor:
    return (0.114 * imgs[..., 0] + 0.587 * imgs[..., 1]
            + 0.299 * imgs[..., 2])
