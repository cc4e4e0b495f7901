"""The seam cut, judged by a plain max-flow.

The stitcher's graph-cut seams (Kwatra et al., as the upstream
SimplePanorama's ``gcut::graph_cut`` cuts them) are incremental: images
are pasted in the bundle adjustment's order, and each new image's share
of its overlap with the canvas built so far is the source side of a
minimum s-t cut of a grid graph:

- nodes: the overlap pixels (canvas built so far, and the new image);
- n-links between 4-neighbours, both nodes, of capacity
  ``(|I1 - I2|(p) + |I1 - I2|(q)) / (g(p) + g(q) + 1e-6)``, with ``g`` the
  summed magnitudes of both images' Scharr gradient across the edge
  (y-gradients for horizontal edges, x-gradients for vertical ones), on
  the luma ``0.114 B + 0.587 G + 0.299 R``, zero outside the block;
- t-links of 5000: to the source on the canvas mask's contour, to the
  sink on the new image's (a contour pixel has a pixel outside its mask
  among its 8 neighbours, or lies on the block's border).

The last image's cut is what its final seam mask shows on the overlap
(no later image takes pixels from it), so it is judged here: this module
rebuilds its graph from the program's warped blocks and the other images'
final seam masks (the canvas before the last image), in float64, prices
the program's cut, and solves the same graph with SciPy's Dinic max-flow.
``cut_excess`` is the program's cut over the minimum, less 1: 0 for a
minimum cut. One connected part of the overlap is solved (the caller
picks which): the parts are independent problems, and a part of some
200k pixels takes SciPy about ten seconds.

Plain NumPy and SciPy; nothing of the program is imported.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import scipy.ndimage as ndi
import scipy.sparse as sp
from scipy.sparse.csgraph import maximum_flow

SEED_W = 5000.0
EPS = 1e-6


def luma(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    return 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]


def scharr(img: np.ndarray):
    """Scharr x and y gradients (cross-correlation), zero outside."""
    P = np.pad(img, 1)
    gx = (3.0 * (P[:-2, 2:] - P[:-2, :-2])
          + 10.0 * (P[1:-1, 2:] - P[1:-1, :-2])
          + 3.0 * (P[2:, 2:] - P[2:, :-2]))
    gy = (3.0 * (P[2:, :-2] - P[:-2, :-2])
          + 10.0 * (P[2:, 1:-1] - P[:-2, 1:-1])
          + 3.0 * (P[2:, 2:] - P[:-2, 2:]))
    return gx, gy


def contour(mask: np.ndarray) -> np.ndarray:
    """Pixels of ``mask`` with a pixel outside it among their 8
    neighbours, or on the block's border."""
    P = np.pad(mask, 1, constant_values=True)
    h, w = mask.shape
    inner = np.ones_like(mask)
    for dy in range(3):
        for dx in range(3):
            inner &= P[dy:dy + h, dx:dx + w]
    inner[0, :] = inner[-1, :] = inner[:, 0] = inner[:, -1] = False
    return mask & ~inner


def cut_graph(canvas: np.ndarray, new: np.ndarray, scene: np.ndarray,
              mask: np.ndarray):
    """(cap_h, cap_v, excess, node) of one cut over a block: ``canvas``
    and ``new`` the luma of the canvas built so far and of the new image,
    ``scene`` and ``mask`` their masks. ``cap_h[y, x]`` is the edge
    (y, x)-(y, x + 1), ``cap_v[y, x]`` the edge (y, x)-(y + 1, x)."""
    node = scene & mask
    A = np.abs(canvas - new)
    g1x, g1y = scharr(canvas)
    g2x, g2y = scharr(new)
    ay = np.abs(g1y) + np.abs(g2y)
    ax = np.abs(g1x) + np.abs(g2x)
    cap_h = np.zeros_like(A)
    cap_v = np.zeros_like(A)
    cap_h[:, :-1] = (A[:, :-1] + A[:, 1:]) / (ay[:, :-1] + ay[:, 1:] + EPS)
    cap_v[:-1] = (A[:-1] + A[1:]) / (ax[:-1] + ax[1:] + EPS)
    src = contour(scene) & node
    snk = contour(mask) & node & ~src
    excess = SEED_W * src - SEED_W * snk
    return cap_h, cap_v, excess, node


def cut_value(cap_h, cap_v, excess, node, side) -> float:
    """The cost of the cut ``side`` (True: source side) induces: the
    n-links between nodes it separates, and the t-links it cuts."""
    S = side & node
    T = ~side & node
    ch = ((S[:, :-1] & T[:, 1:]) | (T[:, :-1] & S[:, 1:])) \
        & node[:, :-1] & node[:, 1:]
    cv = ((S[:-1] & T[1:]) | (T[:-1] & S[1:])) & node[:-1] & node[1:]
    return float(cap_h[:, :-1][ch].sum() + cap_v[:-1][cv].sum()
                 + np.where(T, np.maximum(excess, 0), 0).sum()
                 + np.where(S, np.maximum(-excess, 0), 0).sum())


def min_cut_value(cap_h, cap_v, excess, node, upper: float) -> float:
    """The minimum cut of the graph, by SciPy's Dinic max-flow on
    integer capacities. ``upper`` is the value of some cut: a capacity
    above it lies in no minimum cut, so capacities are clipped to it and
    scaled so that every flow fits 32-bit integers; the rounding moves
    the result by under 1e-6 of ``upper``."""
    n = int(node.sum())
    if n == 0 or upper <= 0:
        return 0.0
    idx = np.full(node.shape, -1, np.int64)
    idx[node] = np.arange(n)
    s, t = n, n + 1
    eh = node[:, :-1] & node[:, 1:]
    ev = node[:-1] & node[1:]
    a = [idx[:, :-1][eh], idx[:-1][ev]]
    b = [idx[:, 1:][eh], idx[1:][ev]]
    w = [cap_h[:, :-1][eh], cap_v[:-1][ev]]
    rows = np.concatenate(a + b)
    cols = np.concatenate(b + a)
    caps = np.concatenate(w + w)
    pos = excess > 0
    neg = (excess < 0) & node
    pos &= node
    rows = np.concatenate([rows, np.full(int(pos.sum()), s), idx[neg]])
    cols = np.concatenate([cols, idx[pos], np.full(int(neg.sum()), t)])
    caps = np.concatenate([caps, excess[pos], -excess[neg]])
    scale = math.floor((2 ** 31 - 1) / (4.0 * upper))
    icaps = np.round(np.minimum(caps, upper) * scale).astype(np.int32)
    keep = icaps > 0
    g = sp.csr_array((icaps[keep], (rows[keep], cols[keep])),
                     shape=(n + 2, n + 2))
    return maximum_flow(g, s, t, method="dinic").flow_value / scale


def last_cut(imgs: np.ndarray, masks: np.ndarray, seams: np.ndarray,
             offs: np.ndarray, seq: Sequence[int], canvas_hw,
             part_draw: float) -> Dict[str, float]:
    """Judge the last image's cut of one panorama.

    ``imgs`` (N, Hb, Wb, 3), ``masks`` and ``seams`` (N, Hb, Wb) are the
    program's warped blocks, footprints and final seam masks, placed on
    the canvas at ``offs`` (N, 2) = (y, x); ``seq`` is the order the
    images were pasted in. The canvas before the last image shows, at
    each pixel, the image whose final seam mask holds it, or where the
    last image holds it, the latest earlier image that covers it (a
    pixel that two earlier images cover is counted in ``ambiguous_px``).
    ``part_draw`` in [0, 1) picks the connected part of the overlap that
    is solved, in proportion to the parts' pixels. Returns the part's
    ``cut_excess``, the program's and the minimum cut's values, the
    part's and the overlap's nodes."""
    N, Hb, Wb = masks.shape
    H, W = canvas_hw
    L = int(seq[-1])
    earlier = [int(s) for s in seq[:-1]]
    owner = np.full((H + Hb, W + Wb), -1, np.int64)
    cover_last = np.full((H + Hb, W + Wb), -1, np.int64)
    covers = np.zeros((H + Hb, W + Wb), np.int32)
    for s in earlier:
        y, x = offs[s]
        cover_last[y:y + Hb, x:x + Wb][masks[s]] = s
        covers[y:y + Hb, x:x + Wb] += masks[s]
    for s in seq:
        y, x = offs[s]
        owner[y:y + Hb, x:x + Wb][seams[s]] = s
    y0, x0 = offs[L]
    own = owner[y0:y0 + Hb, x0:x0 + Wb]
    prior = np.where((own >= 0) & (own != L), own,
                     cover_last[y0:y0 + Hb, x0:x0 + Wb])
    ambiguous = (own == L) & (covers[y0:y0 + Hb, x0:x0 + Wb] > 1)
    canvas = np.zeros((Hb, Wb))
    for s in earlier:
        sel = prior == s
        if sel.any():
            yy, xx = np.nonzero(sel)
            sy, sx = offs[s]
            canvas[sel] = luma(imgs[s][yy + y0 - sy, xx + x0 - sx])
    scene = covers[y0:y0 + Hb, x0:x0 + Wb] > 0
    cap_h, cap_v, excess, node = cut_graph(canvas, luma(imgs[L]), scene,
                                           masks[L])
    labels, n_parts = ndi.label(node)
    if n_parts == 0:
        return {"cut_excess": math.inf, "parts": 0}
    sizes = np.bincount(labels.ravel())[1:]
    # a part is drawn in proportion to its pixels
    part = 1 + int(np.searchsorted(np.cumsum(sizes) / sizes.sum(),
                                   part_draw, side="right"))
    part = min(part, n_parts)
    sub = labels == part
    side = seams[L]
    prog = cut_value(cap_h, cap_v, excess, sub, side)
    trivial = min(float(np.maximum(excess[sub], 0).sum()),
                  float(np.maximum(-excess[sub], 0).sum()))
    upper = min(prog, trivial)
    best = min_cut_value(cap_h, cap_v, excess, sub, upper)
    excess_share = (prog - best) / best if best > 0 else (
        0.0 if prog <= 0 else math.inf)
    return {"cut_excess": float(excess_share), "cut_prog": prog,
            "cut_min": best, "part": part, "parts": int(n_parts),
            "part_nodes": int(sizes[part - 1]), "nodes": int(node.sum()),
            "ambiguous_px": int((ambiguous & sub).sum())}
