"""Fixed-shape convex-polygon math for overlap-aware match verification.

Port of simplepanorama_tpu/ops/polygon.py (keypoints_in_overlap_centered
of the reference). The clip region is an axis-aligned rect, so the
intersection is a Sutherland-Hodgman clip of the projected quad by 4
half-planes in a static 8-vertex buffer; a point is inside the
intersection iff it is inside the rect and inside the quad. Every
function carries a leading batch dimension B of image pairs.
"""

from __future__ import annotations

from typing import Tuple

import torch

_CAP = 8  # max vertices of quad ∩ rect


def _clip_halfplane(pts, n, sign: float, axis: int, bound):
    """One Sutherland-Hodgman pass keeping sign*(coord - bound) <= 0.
    pts: (B, _CAP, 2), n: (B,) vertex counts, bound: (B,)."""
    B = pts.shape[0]
    dev = pts.device
    slots = torch.arange(_CAP, device=dev)
    out = torch.zeros_like(pts)
    m = torch.zeros(B, dtype=torch.int64, device=dev)
    n_safe = torch.clamp(n, min=1)

    def emit(out, m, p, cond):
        hit = ((slots == (m % _CAP)[:, None]) & cond[:, None])[..., None]
        return torch.where(hit, p[:, None, :], out), torch.where(cond, m + 1, m)

    for i in range(_CAP):
        cur = pts[:, i]
        nxt = torch.gather(pts, 1, ((i + 1) % n_safe)[:, None, None]
                           .expand(-1, 1, 2))[:, 0]
        dc = sign * (cur[:, axis] - bound)
        dn = sign * (nxt[:, axis] - bound)
        inside_c = dc <= 0
        inside_n = dn <= 0
        den = dc - dn
        t = dc / torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
        inter = cur + t[:, None] * (nxt - cur)
        valid_i = i < n
        out, m = emit(out, m, cur, valid_i & inside_c)
        out, m = emit(out, m, inter, valid_i & (inside_c != inside_n))
    return out, torch.clamp(m, max=_CAP)


def quad_rect_intersection_area(quad, half_w, half_h):
    """Area of quad ∩ [-half_w, half_w] x [-half_h, half_h]; quad (B, 4, 2),
    half sizes (B,)."""
    B = quad.shape[0]
    pts = torch.zeros((B, _CAP, 2), dtype=quad.dtype, device=quad.device)
    pts[:, :4] = quad
    n = torch.full((B,), 4, dtype=torch.int64, device=quad.device)
    pts, n = _clip_halfplane(pts, n, -1.0, 0, -half_w)
    pts, n = _clip_halfplane(pts, n, 1.0, 0, half_w)
    pts, n = _clip_halfplane(pts, n, -1.0, 1, -half_h)
    pts, n = _clip_halfplane(pts, n, 1.0, 1, half_h)

    idx = torch.arange(_CAP, device=quad.device)
    mask = idx < n[:, None]
    zero = torch.zeros_like(pts[..., 0])
    x = torch.where(mask, pts[..., 0], zero)
    y = torch.where(mask, pts[..., 1], zero)
    nxt = (idx + 1) % torch.clamp(n, min=1)[:, None]
    xs = torch.gather(x, 1, nxt)
    ys = torch.gather(y, 1, nxt)
    terms = torch.where(mask, x * ys - xs * y, zero)
    return 0.5 * torch.abs(terms.sum(-1))


def points_in_quad(pts, quad):
    """Inside-or-on-edge test of (B, M, 2) points vs convex (B, 4, 2) quads."""
    nxt = [1, 2, 3, 0]
    e = quad[:, nxt] - quad
    orient = torch.sign(torch.sum(quad[..., 0] * quad[:, nxt, 1]
                                  - quad[:, nxt, 0] * quad[..., 1], -1))
    orient = torch.where(orient == 0, torch.ones_like(orient), orient)
    d = pts[:, :, None, :] - quad[:, None, :, :]          # (B, M, 4, 2)
    cross = e[:, None, :, 0] * d[..., 1] - e[:, None, :, 1] * d[..., 0]
    return (orient[:, None, None] * cross >= 0).all(-1)


def overlap_stats(H, img1_hw, img2_hw, kp1, kp1_valid, match_q, match_valid
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Overlap stats in image-1's centered frame for B pairs. H maps
    image-2 coords into image-1. Returns (overlap fraction of image 1,
    keypoints in the overlap, matches in the overlap), each (B,)."""
    h1, w1 = img1_hw[:, 0].to(torch.float32), img1_hw[:, 1].to(torch.float32)
    h2, w2 = img2_hw[:, 0].to(torch.float32), img2_hw[:, 1].to(torch.float32)
    rx = torch.tensor([-1.0, 1.0, 1.0, -1.0], device=H.device) * (w2 / 2)[:, None]
    ry = torch.tensor([-1.0, -1.0, 1.0, 1.0], device=H.device) * (h2 / 2)[:, None]
    h = lambda i, j: H[:, i, j, None]
    x = rx * h(0, 0) + ry * h(0, 1) + h(0, 2)
    y = rx * h(1, 0) + ry * h(1, 1) + h(1, 2)
    w = rx * h(2, 0) + ry * h(2, 1) + h(2, 2)
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    quad = torch.stack([x / w, y / w], -1)

    area = quad_rect_intersection_area(quad, w1 / 2, h1 / 2)
    overlap_frac = area / (w1 * h1)

    def in_rect(p):
        return ((torch.abs(p[..., 0]) <= (w1 / 2)[:, None])
                & (torch.abs(p[..., 1]) <= (h1 / 2)[:, None]))
    kp_in = points_in_quad(kp1, quad) & in_rect(kp1) & kp1_valid
    m_in = points_in_quad(match_q, quad) & in_rect(match_q) & match_valid
    return overlap_frac, kp_in.sum(-1), m_in.sum(-1)
