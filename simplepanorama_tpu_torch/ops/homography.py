"""Homography estimation: normalized DLT + batched-hypothesis RANSAC.

Port of simplepanorama_tpu/ops/homography.py (util::find_homography of
the reference). Every function takes leading batch dimensions in place of
vmap: RANSAC runs a batch of B image pairs x n_iter hypotheses at once,
and the reference's sequential accept rule ("keep H only when the loss
strictly improves the running best AND sanity passes") is reproduced
with an exclusive running minimum over hypothesis losses.

The (n_iter, M) uniform draws that pick each hypothesis' 4 matches are an
input (``draws``), so a caller can feed any stream: the pipeline draws
them from a ``torch.Generator``, the parity tests feed JAX's.
"""

from __future__ import annotations

from typing import Tuple

import torch


def apply_h(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Perspective-transform (..., M, 2) points by (..., 3, 3) H."""
    h = lambda i, j: H[..., i, j, None]
    x = pts[..., 0] * h(0, 0) + pts[..., 1] * h(0, 1) + h(0, 2)
    y = pts[..., 0] * h(1, 0) + pts[..., 1] * h(1, 1) + h(1, 2)
    w = pts[..., 0] * h(2, 0) + pts[..., 1] * h(2, 1) + h(2, 2)
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.stack([x / w, y / w], -1)


def _cholesky_solve_unrolled(A, b, n: int = 8):
    """Solve SPD A x = b by the unrolled scalar Cholesky of the JAX
    package (elementwise over the batch dims); A (..., n, n), b (..., n)."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp(d, min=1e-20))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def _normalize_2d(pts):
    """Conditioning (util::Normalize2D): returns (tr, sc), each (..., 2),
    of T = [[1/sx, 0, -tx/sx], [0, 1/sy, -ty/sy], [0, 0, 1]]."""
    tr = pts.mean(dim=-2)
    sc = torch.clamp(torch.abs(pts - tr[..., None, :]).mean(dim=-2), min=1e-8)
    return tr, sc


def normalize_2d(pts: torch.Tensor) -> torch.Tensor:
    """Conditioning matrix of (..., n, 2) points: translate by the mean,
    scale per axis by the mean absolute deviation (util::Normalize2D,
    _homography.cpp:144-168)."""
    return _cond_matrix(*_normalize_2d(pts))


def _cond_matrix(tr, sc):
    z = torch.zeros_like(tr[..., 0])
    o = torch.ones_like(z)
    return torch.stack([
        torch.stack([1.0 / sc[..., 0], z, -tr[..., 0] / sc[..., 0]], -1),
        torch.stack([z, 1.0 / sc[..., 1], -tr[..., 1] / sc[..., 1]], -1),
        torch.stack([z, z, o], -1)], -2)


def dlt_homography(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """Normalized DLT from (..., n, 2) correspondences: H maps train ->
    query, with h'_22 pinned to 1 and the 2n x 8 system solved by normal
    equations (unrolled Cholesky), then deconditioned."""
    Tq = _cond_matrix(*_normalize_2d(query))
    Tt = _cond_matrix(*_normalize_2d(train))
    q = apply_h(Tq, query)
    t = apply_h(Tt, train)
    ones = torch.ones_like(q[..., 0])
    zeros = torch.zeros_like(ones)
    rx = torch.stack([t[..., 0], t[..., 1], ones, zeros, zeros, zeros,
                      -q[..., 0] * t[..., 0], -q[..., 0] * t[..., 1]], -1)
    ry = torch.stack([zeros, zeros, zeros, t[..., 0], t[..., 1], ones,
                      -q[..., 1] * t[..., 0], -q[..., 1] * t[..., 1]], -1)
    A = torch.cat([rx, ry], -2)                          # (..., 2n, 8)
    b = torch.cat([q[..., 0], q[..., 1]], -1)            # (..., 2n)
    At = A.transpose(-1, -2)
    AtA = At @ A + 1e-12 * torch.eye(8, dtype=A.dtype, device=A.device)
    h8 = _cholesky_solve_unrolled(AtA, (At @ b[..., None])[..., 0], 8)
    Hc = torch.cat([h8, torch.ones_like(h8[..., :1])], -1)
    Hc = Hc.reshape(h8.shape[:-1] + (3, 3))
    # closed-form inverse of the query conditioning matrix
    a, c, d, e = Tq[..., 0, 0], Tq[..., 0, 2], Tq[..., 1, 1], Tq[..., 1, 2]
    ia, id_ = 1.0 / a, 1.0 / d
    z = torch.zeros_like(a)
    o = torch.ones_like(a)
    Tq_inv = torch.stack([torch.stack([ia, z, -c * ia], -1),
                          torch.stack([z, id_, -e * id_], -1),
                          torch.stack([z, z, o], -1)], -2)
    return Tq_inv @ Hc @ Tt


def hom_sanity(H: torch.Tensor, img1_hw: torch.Tensor,
               img2_hw: torch.Tensor) -> torch.Tensor:
    """Sanity predicate (util::hom_sanity): finite, non-reflecting,
    bounded perspective terms, convex projected image-1 quad with area
    >= |img1|/200 and corners within 8000x image-2 scale. H (..., 3, 3);
    hw (..., 2) broadcastable."""
    h1, w1 = img1_hw[..., 0], img1_hw[..., 1]
    h2, w2 = img2_hw[..., 0], img2_hw[..., 1]
    finite = torch.isfinite(H).flatten(-2).all(-1)
    det2 = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    skew_ok = (H[..., 2, 0] <= 0.003) & (H[..., 2, 1] <= 0.003)

    cx = torch.tensor([0.0, 1.0, 1.0, 0.0], device=H.device)
    cy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=H.device)
    cx = cx * w1.to(torch.float32)[..., None]
    cy = cy * h1.to(torch.float32)[..., None]
    h = lambda i, j: H[..., i, j, None]
    x = cx * h(0, 0) + cy * h(0, 1) + h(0, 2)
    y = cx * h(1, 0) + cy * h(1, 1) + h(1, 2)
    w = cx * h(2, 0) + cy * h(2, 1) + h(2, 2)
    w_ok = (torch.abs(w) >= 1e-6).all(-1)
    w_safe = torch.where(torch.abs(w) < 1e-6, torch.full_like(w, 1e-6), w)
    px = x / w_safe
    py = y / w_safe

    nxt = [1, 2, 3, 0]
    ex = px[..., nxt] - px
    ey = py[..., nxt] - py
    cross = ex * ey[..., nxt] - ey * ex[..., nxt]
    convex = (cross >= 0).all(-1) | (cross <= 0).all(-1)
    area = 0.5 * torch.abs(torch.sum(px * py[..., nxt] - px[..., nxt] * py, -1))
    area_ok = area >= (w1 * h1).to(torch.float32) / 200.0
    inf_ok = ((torch.abs(px) <= 8000.0 * w2.to(torch.float32)[..., None])
              & (torch.abs(py) <= 8000.0 * h2.to(torch.float32)[..., None])).all(-1)
    return finite & (det2 > 0) & skew_ok & w_ok & convex & area_ok & inf_ok


def ransac_homography(query: torch.Tensor, train: torch.Tensor,
                      valid: torch.Tensor, img1_hw: torch.Tensor,
                      img2_hw: torch.Tensor, draws: torch.Tensor,
                      margin: float = 4.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched-hypothesis RANSAC over B pairs; H maps train -> query.

    query/train: (B, M, 2) padded match coords; valid: (B, M) bool;
    img*_hw: (B, 2); draws: (B, n_iter, M) uniforms in [0, 1). Returns
    (H (B, 3, 3), inliers (B, M)); identity where nothing is accepted."""
    B, n_iter, M = draws.shape
    # 4 distinct valid indices per hypothesis: top-4 of masked uniforms
    # as 4 successive first-occurrence argmax passes
    neg_inf = torch.full_like(draws, -float("inf"))
    gumbel = torch.where(valid[:, None, :], draws, neg_inf)
    iota = torch.arange(M, device=draws.device)
    picks = []
    for _ in range(4):
        a = torch.argmax(gumbel, dim=2)
        picks.append(a)
        gumbel = torch.where(iota == a[..., None], neg_inf, gumbel)
    sample_idx = torch.stack(picks, -1)                   # (B, n_iter, 4)
    gi = sample_idx.reshape(B, -1, 1).expand(-1, -1, 2)
    q4 = torch.gather(query, 1, gi).reshape(B, n_iter, 4, 2)
    t4 = torch.gather(train, 1, gi).reshape(B, n_iter, 4, 2)
    Hs = dlt_homography(q4, t4)                           # (B, n_iter, 3, 3)

    n_valid = torch.clamp(valid.sum(-1), min=1)

    def loss_of(H):                                       # H (B, I, 3, 3)
        pred = apply_h(H, train[:, None])
        d = torch.linalg.norm(pred - query[:, None], dim=-1)
        inl = (d < margin) & valid[:, None]
        return 1.0 - inl.sum(-1) / n_valid[:, None]

    losses = loss_of(Hs)
    sane = hom_sanity(Hs, img1_hw[:, None], img2_hw[:, None])
    eye = torch.eye(3, dtype=Hs.dtype, device=Hs.device)
    eye_loss = loss_of(eye.expand(B, 1, 3, 3))            # (B, 1)
    prefix = torch.cummin(losses, dim=1).values
    prev_best = torch.minimum(torch.cat([eye_loss, prefix[:, :-1]], 1),
                              eye_loss)
    accepted = (losses < prev_best) & sane
    idx = torch.arange(n_iter, device=draws.device)
    last = torch.where(accepted, idx, -1).max(dim=1).values
    H_last = Hs[torch.arange(B, device=draws.device), torch.clamp(last, min=0)]
    H_best = torch.where((last >= 0)[:, None, None], H_last, eye)

    d = torch.linalg.norm(apply_h(H_best, train) - query, dim=-1)
    return H_best, (d <= margin) & valid


def inlier_distances(H: torch.Tensor, query: torch.Tensor,
                     train: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Reprojection distances |q - H t| with +inf on padding."""
    d = torch.linalg.norm(apply_h(H, train) - query, dim=-1)
    return torch.where(valid, d, torch.full_like(d, float("inf")))
