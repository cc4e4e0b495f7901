"""SIFT: DoG scale-space detector + canonical-grid descriptor in PyTorch.

Port of simplepanorama_tpu/ops/sift.py (the reference delegates to
OpenCV's SIFT and post-processes to rootSIFT). Same algorithm, with an
explicit batch dimension N over images in place of vmap:

  * the Gaussian pyramid is two separable convolutions per octave (a
    1 -> L channel horizontal pass, an L-group vertical pass), every level
    blurred directly from the octave base;
  * scale-space extrema come from 3x3x3 max/min pooling of the DoG stack;
  * sub-pixel refinement is the dense closed-form 3x3 fit over the whole
    stack, candidates are the top-k of an int-encoded 2x2-block-pooled
    score, and OpenCV's movement iteration re-reads the dense fit;
  * orientation and descriptor sample dense central-difference gradients
    (rounded to bfloat16 like the JAX package) on a fixed grid in the
    keypoint frame; descriptors are rootSIFT.

Top-k selections use a stable descending sort, so ties resolve to the
lower index as lax.top_k does.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

_IMG_BORDER = 5
_MAX_INTERP_STEPS = 5
_ORI_SIG_FCTR = 1.5
_ORI_RADIUS = 3 * _ORI_SIG_FCTR
_ORI_HIST_BINS = 36
_DESCR_WIDTH = 4
_DESCR_HIST_BINS = 8
_DESCR_SCL_FCTR = 3.0
_DESCR_MAG_THR = 0.2
_ORI_GRID = 17
_DESCR_GRID = 16


class SiftFeatures(NamedTuple):
    """Fixed-capacity keypoints + descriptors, batched (N, K, ...)."""
    xy: torch.Tensor        # (N, K, 2) original-image pixel coords
    size: torch.Tensor      # (N, K)
    response: torch.Tensor  # (N, K)
    desc: torch.Tensor      # (N, K, 128) rootSIFT
    valid: torch.Tensor     # (N, K) bool


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Gaussian pyramid
# ---------------------------------------------------------------------------

def _from_base_sigmas(sigma: float, n_layers: int) -> List[float]:
    """Blur of every level directly from the octave base (Gaussian
    semigroup equivalent of OpenCV's incremental chain)."""
    k = 2.0 ** (1.0 / n_layers)
    out = [0.0]
    for i in range(1, n_layers + 3):
        sig_total = (k ** i) * sigma
        out.append(math.sqrt(max(sig_total ** 2 - sigma ** 2, 1e-8)))
    return out


def _multi_kernels(sigmas: List[float]) -> np.ndarray:
    """(L, T) taps, zero-padded to the widest radius; sigma 0 = delta."""
    rads = [max(1, int(round(s * 4))) if s > 0 else 0 for s in sigmas]
    R = max(rads)
    T = 2 * R + 1
    ks = np.zeros((len(sigmas), T), np.float32)
    for i, s in enumerate(sigmas):
        if s <= 0:
            ks[i, R] = 1.0
            continue
        r = rads[i]
        x = np.arange(-r, r + 1, dtype=np.float64)
        k = np.exp(-(x * x) / (2.0 * s * s))
        ks[i, R - r:R + r + 1] = (k / k.sum()).astype(np.float32)
    return ks


def _blur_multi(base: torch.Tensor, sigmas: List[float]) -> torch.Tensor:
    """(N, H, W) octave bases -> (N, L, H, W), level l blurred by
    sigmas[l], replicate borders."""
    ks = torch.as_tensor(_multi_kernels(sigmas), device=base.device)
    L, T = ks.shape
    R = (T - 1) // 2
    x = F.pad(base[:, None], (R, R, 0, 0), mode="replicate")
    x = F.conv2d(x, ks[:, None, None, :])
    x = F.pad(x, (0, 0, R, R), mode="replicate")
    return F.conv2d(x, ks[:, None, :, None], groups=L)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of one (H, W) image, replicate borders,
    4 sigma each side (the JAX package's _blur)."""
    if sigma <= 0:
        return img
    return _blur_multi(img[None], [sigma])[0, 0]


def build_pyramid_batch(base: torch.Tensor, sigma: float, n_layers: int,
                        n_octaves: int) -> List[torch.Tensor]:
    """List over octaves of (N, L, H_o, W_o); the next octave's base is
    level ``n_layers`` subsampled by 2 (OpenCV buildGaussianPyramid)."""
    sigs = _from_base_sigmas(sigma, n_layers)
    octaves = []
    cur = base
    for _ in range(n_octaves):
        oct_ = _blur_multi(cur, sigs)
        octaves.append(oct_)
        cur = oct_[:, n_layers, ::2, ::2]
    return octaves


def build_pyramid(base: torch.Tensor, sigma: float, n_layers: int,
                  n_octaves: int) -> List[torch.Tensor]:
    """Gaussian pyramid of one (H, W) image: list over octaves of
    (L, H_o, W_o)."""
    return [o[0] for o in build_pyramid_batch(base[None], sigma, n_layers,
                                              n_octaves)]


# ---------------------------------------------------------------------------
# Extrema refinement (dense, per octave)
# ---------------------------------------------------------------------------

def _dense_refine(dog: torch.Tensor, n_layers: int, contrast_thresh: float,
                  edge_thresh: float):
    """Dense sub-pixel refinement of a (N, L, H, W) DoG stack (OpenCV
    adjustLocalExtrema math on a 0..255 scale). Returns (ok, x_off,
    y_off, l_off, response, interior) maps."""
    _, L, H, W = dog.shape
    img_scale = 1.0 / 255.0
    deriv_s = img_scale * 0.5
    second_s = img_scale
    cross_s = img_scale * 0.25

    d = dog
    dp = F.pad(d, (1, 1, 1, 1, 1, 1))

    def sh(dl=0, dy=0, dx=0):
        return dp[:, 1 + dl:1 + dl + L, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    dDx = (sh(0, 0, 1) - sh(0, 0, -1)) * deriv_s
    dDy = (sh(0, 1, 0) - sh(0, -1, 0)) * deriv_s
    dDs = (sh(1, 0, 0) - sh(-1, 0, 0)) * deriv_s
    dxx = (sh(0, 0, 1) + sh(0, 0, -1) - 2 * d) * second_s
    dyy = (sh(0, 1, 0) + sh(0, -1, 0) - 2 * d) * second_s
    dss = (sh(1, 0, 0) + sh(-1, 0, 0) - 2 * d) * second_s
    dxy = (sh(0, 1, 1) - sh(0, 1, -1) - sh(0, -1, 1) + sh(0, -1, -1)) * cross_s
    dxs = (sh(1, 0, 1) - sh(1, 0, -1) - sh(-1, 0, 1) + sh(-1, 0, -1)) * cross_s
    dys = (sh(1, 1, 0) - sh(1, -1, 0) - sh(-1, 1, 0) + sh(-1, -1, 0)) * cross_s

    # closed-form 3x3 solve X = -H^-1 dD via cofactors
    c00 = dyy * dss - dys * dys
    c01 = dxs * dys - dxy * dss
    c02 = dxy * dys - dxs * dyy
    c11 = dxx * dss - dxs * dxs
    c12 = dxy * dxs - dxx * dys
    c22 = dxx * dyy - dxy * dxy
    det = dxx * c00 + dxy * c01 + dxs * c02
    bad_det = torch.abs(det) < 1e-20
    safe = torch.where(bad_det, torch.full_like(det, 1e-20), det)
    zero = torch.zeros_like(det)
    x_off = torch.where(bad_det, zero, -(c00 * dDx + c01 * dDy + c02 * dDs) / safe)
    y_off = torch.where(bad_det, zero, -(c01 * dDx + c11 * dDy + c12 * dDs) / safe)
    l_off = torch.where(bad_det, zero, -(c02 * dDx + c12 * dDy + c22 * dDs) / safe)

    converged = ((torch.abs(x_off) < 0.5) & (torch.abs(y_off) < 0.5)
                 & (torch.abs(l_off) < 0.5)) & (~bad_det)

    contr = d * img_scale + 0.5 * (dDx * x_off + dDy * y_off + dDs * l_off)
    contrast_ok = torch.abs(contr) * n_layers >= contrast_thresh

    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = edge_thresh
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) * (r + 1) * det2)

    ll = torch.arange(L, device=d.device)[:, None, None]
    yy = torch.arange(H, device=d.device)[None, :, None]
    xx = torch.arange(W, device=d.device)[None, None, :]
    interior = ((ll >= 1) & (ll <= n_layers)
                & (yy >= _IMG_BORDER) & (yy < H - _IMG_BORDER)
                & (xx >= _IMG_BORDER) & (xx < W - _IMG_BORDER))
    interior = interior.expand(d.shape)

    ok = converged & contrast_ok & edge_ok & interior
    return ok, x_off, y_off, l_off, torch.abs(contr), interior


# ---------------------------------------------------------------------------
# Canonical-grid sampling
# ---------------------------------------------------------------------------

def grad_stack(level_imgs: torch.Tensor) -> torch.Tensor:
    """Central-difference gradients of a (..., H, W) level stack as
    (..., H, W, 2) = (dx, dy) in bfloat16; dy is upward-positive,
    I(y-1) - I(y+1), like OpenCV. Border rows/cols are zero."""
    dx = F.pad(level_imgs[..., :, 2:] - level_imgs[..., :, :-2], (1, 1))
    dy = F.pad(level_imgs[..., :-2, :] - level_imgs[..., 2:, :], (0, 0, 1, 1))
    return torch.stack([dx, dy], -1).to(torch.bfloat16)


def _grad_at(flat, off, H, W, l, ys, xs):
    """Bilinear sample of the dense gradient field.

    flat: (N, T, 2) bf16 gradients of every octave, flattened; off, H, W,
    l: (N, K) per-keypoint octave offset / size and layer; ys, xs:
    (N, K, S) sample positions. Returns (gx, gy), each (N, K, S) f32."""
    H = H[..., None]
    W = W[..., None]
    x0 = torch.minimum(torch.clamp(torch.floor(xs), min=0), (W - 2).to(xs.dtype)).to(torch.int64)
    y0 = torch.minimum(torch.clamp(torch.floor(ys), min=0), (H - 2).to(ys.dtype)).to(torch.int64)
    fx = torch.clamp(xs - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(ys - y0, 0.0, 1.0)[..., None]
    base = off[..., None] + l[..., None] * (H * W) + y0 * W + x0
    N = flat.shape[0]

    def tap(idx):
        i = idx.reshape(N, -1, 1).expand(-1, -1, 2)
        return torch.gather(flat, 1, i).reshape(idx.shape + (2,)).to(torch.float32)
    v00, v01 = tap(base), tap(base + 1)
    v10, v11 = tap(base + W), tap(base + W + 1)
    g = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
         + (v10 * (1 - fx) + v11 * fx) * fy)
    return g[..., 0], g[..., 1]


def _orientation(pyr, l, y, x, scl_octv):
    """Dominant gradient orientation (degrees, [0, 360)) of (N, K)
    keypoints from a fixed 17x17 grid over radius 4.5 sigma."""
    G = _ORI_GRID
    lin = np.linspace(-1.0, 1.0, G, dtype=np.float32)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    o_y = torch.as_tensor(gy.ravel(), device=y.device)
    o_x = torch.as_tensor(gx.ravel(), device=y.device)
    radius = (_ORI_RADIUS * scl_octv)[..., None]
    ys = y[..., None] + o_y * radius
    xs = x[..., None] + o_x * radius
    dx, dy = _grad_at(*pyr, l, ys, xs)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.rad2deg(torch.atan2(dy, dx)) % 360.0
    d2 = (o_y * radius) ** 2 + (o_x * radius) ** 2
    w = torch.exp(-d2 / (2.0 * ((_ORI_SIG_FCTR * scl_octv) ** 2)[..., None]))
    wmag = mag * w

    bins = ang * (_ORI_HIST_BINS / 360.0)
    b0f = torch.floor(bins)
    fb = bins - b0f
    b0 = b0f.to(torch.int64) % _ORI_HIST_BINS
    b1 = (b0 + 1) % _ORI_HIST_BINS
    oh0 = F.one_hot(b0, _ORI_HIST_BINS) * ((1 - fb) * wmag)[..., None]
    oh1 = F.one_hot(b1, _ORI_HIST_BINS) * (fb * wmag)[..., None]
    h = torch.sum(oh0 + oh1, dim=-2)                        # (N, K, 36)
    hm1, hp1 = torch.roll(h, 1, -1), torch.roll(h, -1, -1)
    hm2, hp2 = torch.roll(h, 2, -1), torch.roll(h, -2, -1)
    hist = (6 * h + 4 * (hm1 + hp1) + (hm2 + hp2)) / 16.0

    k = torch.argmax(hist, dim=-1, keepdim=True)
    hk = torch.gather(hist, -1, k)
    hl = torch.gather(hist, -1, (k - 1) % _ORI_HIST_BINS)
    hr = torch.gather(hist, -1, (k + 1) % _ORI_HIST_BINS)
    denom = hl - 2 * hk + hr
    interp = torch.where(torch.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom,
                         torch.zeros_like(denom))
    bin_f = (k + interp) % _ORI_HIST_BINS
    return (360.0 - bin_f * (360.0 / _ORI_HIST_BINS))[..., 0]


def _descr_spatial_weights() -> np.ndarray:
    """Static (S*S, d*d) trilinear spatial weights of the canonical
    descriptor grid with the Gaussian window baked in."""
    d = _DESCR_WIDTH
    S = _DESCR_GRID
    lin = (np.arange(S, dtype=np.float64) + 0.5) / S * d - d / 2.0
    rr, cc = np.meshgrid(lin, lin, indexing="ij")
    rbin = rr.ravel() + d / 2.0 - 0.5
    cbin = cc.ravel() + d / 2.0 - 0.5
    gw = np.exp(-(rr.ravel() ** 2 + cc.ravel() ** 2) / (0.5 * d * d))
    Wmat = np.zeros((S * S, d * d), np.float32)
    r0 = np.floor(rbin).astype(int)
    c0 = np.floor(cbin).astype(int)
    fr = rbin - r0
    fc = cbin - c0
    for dr in (0, 1):
        for dc in (0, 1):
            r = r0 + dr
            c = c0 + dc
            wgt = (fr if dr else 1 - fr) * (fc if dc else 1 - fc) * gw
            okm = (r >= 0) & (r < d) & (c >= 0) & (c < d)
            idx = np.clip(r, 0, d - 1) * d + np.clip(c, 0, d - 1)
            for s in range(S * S):
                if okm[s]:
                    Wmat[s, idx[s]] += wgt[s]
    return Wmat


_DESCR_W = _descr_spatial_weights()


def _descriptor(pyr, l, y, x, scl_octv, angle_deg):
    """128-D SIFT descriptors of (N, K) keypoints: canonical 16x16 grid
    resampling + trilinear binning."""
    d, n, S = _DESCR_WIDTH, _DESCR_HIST_BINS, _DESCR_GRID
    hist_width = (_DESCR_SCL_FCTR * scl_octv)[..., None]
    ori = 360.0 - angle_deg
    theta = torch.deg2rad(ori)[..., None]
    ct, st = torch.cos(theta), torch.sin(theta)

    lin = (np.arange(S, dtype=np.float32) + 0.5) / S * d - d / 2.0
    rr, cc = np.meshgrid(lin, lin, indexing="ij")
    rr = torch.as_tensor(rr.ravel(), device=y.device)
    cc = torch.as_tensor(cc.ravel(), device=y.device)
    xs = x[..., None] + (cc * ct + rr * st) * hist_width
    ys = y[..., None] + (-cc * st + rr * ct) * hist_width

    dx, dy = _grad_at(*pyr, l, ys, xs)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.rad2deg(torch.atan2(dy, dx)) % 360.0
    rel = (ang - ori[..., None]) * (n / 360.0)

    ob = rel % n
    o0f = torch.floor(ob)
    fo = ob - o0f
    o0 = o0f.to(torch.int64) % n
    o1 = (o0 + 1) % n
    O = (F.one_hot(o0, n) * (1 - fo)[..., None]
         + F.one_hot(o1, n) * fo[..., None])              # (N, K, S*S, n)
    Wmat = torch.as_tensor(_DESCR_W, device=y.device)
    hist = torch.einsum("sc,bks,bkso->bkco", Wmat, mag, O)
    vec = hist.reshape(hist.shape[:2] + (-1,))
    nrm = torch.linalg.norm(vec, dim=-1, keepdim=True)
    vec = torch.minimum(vec, _DESCR_MAG_THR * torch.clamp(nrm, min=1e-12))
    nrm2 = torch.linalg.norm(vec, dim=-1, keepdim=True)
    return vec / torch.clamp(nrm2, min=1e-12)


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------

def _num_octaves(h: int, w: int) -> int:
    return max(1, int(math.floor(math.log2(min(h, w) / 16.0))) + 1)


def _sift_from_pyramid(gauss, valid_hw, max_kp: int, n_layers: int,
                       contrast_thresh: float, edge_thresh: float,
                       sigma: float, first_octave: int) -> SiftFeatures:
    """Detector + descriptor over a batched Gaussian pyramid (list over
    octaves of (N, L, H_o, W_o))."""
    dev = gauss[0].device
    N = gauss[0].shape[0]
    n_oct = len(gauss)
    prethresh = 0.5 * contrast_thresh / n_layers * 255.0
    budget = max_kp

    all_resp, all_xy, all_size, all_valid = [], [], [], []
    all_oct, all_layer, all_ypix, all_xpix = [], [], [], []
    vh = valid_hw[:, 0:1].to(torch.float32)
    vw = valid_hw[:, 1:2].to(torch.float32)

    for o in range(n_oct):
        g = gauss[o]
        dog = g[:, 1:] - g[:, :-1]
        _, L, Ho, Wo = dog.shape
        ext = F.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
        mn = -F.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
        is_ext = ((dog >= ext) & (dog > prethresh)) \
            | ((dog <= mn) & (dog < -prethresh))

        (ok_map, xo_map, yo_map, lo_map, resp_map,
         interior_map) = _dense_refine(dog, n_layers, contrast_thresh,
                                       edge_thresh)
        # candidate pool: score int-encoded with its 2x2-block offset in
        # the low bits, block-maxed, then top-k over the pooled quarter
        score_map = torch.where(is_ext & interior_map, torch.abs(dog),
                                torch.zeros_like(dog))
        q = torch.clamp(score_map * 131072.0, max=2.0 ** 28 - 1)
        yy_o = torch.arange(Ho, device=dev)[:, None]
        xx_o = torch.arange(Wo, device=dev)[None, :]
        off2 = (((yy_o % 2) << 1) | (xx_o % 2)).to(torch.int32)
        enc = torch.where(q > 0, (q.to(torch.int32) << 2) | off2,
                          torch.zeros_like(off2))
        Hb2, Wb2 = (Ho + 1) // 2, (Wo + 1) // 2
        enc = F.pad(enc, (0, 2 * Wb2 - Wo, 0, 2 * Hb2 - Ho))
        pooled = enc.reshape(N, L, Hb2, 2, Wb2, 2).amax(dim=(3, 5))
        pf = pooled.reshape(N, -1)
        k = min(budget, pf.shape[1])
        enc_k, pidx = _topk_stable(pf, k)
        if budget > k:
            pidx = F.pad(pidx, (0, budget - k))
            enc_k = F.pad(enc_k, (0, budget - k))
        cand = enc_k > 0
        l_i = pidx // (Hb2 * Wb2)
        rem = pidx % (Hb2 * Wb2)
        y_i = (rem // Wb2) * 2 + ((enc_k >> 1) & 1)
        x_i = (rem % Wb2) * 2 + (enc_k & 1)

        xo_f = xo_map.reshape(N, -1)
        yo_f = yo_map.reshape(N, -1)
        lo_f = lo_map.reshape(N, -1)
        ok_f = ok_map.reshape(N, -1)
        resp_f = resp_map.reshape(N, -1)
        int_f = interior_map.reshape(N, -1)

        def at(m, lin):
            return torch.gather(m, 1, lin)

        # OpenCV's movement iteration (adjustLocalExtrema)
        done = torch.zeros_like(cand)
        for _ in range(_MAX_INTERP_STEPS):
            lin = l_i * (Ho * Wo) + y_i * Wo + x_i
            xo, yo, lo = at(xo_f, lin), at(yo_f, lin), at(lo_f, lin)
            conv = (torch.abs(xo) < 0.5) & (torch.abs(yo) < 0.5) \
                & (torch.abs(lo) < 0.5)
            inside = at(int_f, lin)
            move = inside & (~done) & (~conv)
            l_i = torch.where(move, torch.clamp(
                l_i + torch.round(lo).to(l_i.dtype), 0, L - 1), l_i)
            y_i = torch.where(move, torch.clamp(
                y_i + torch.round(yo).to(y_i.dtype), 0, Ho - 1), y_i)
            x_i = torch.where(move, torch.clamp(
                x_i + torch.round(xo).to(x_i.dtype), 0, Wo - 1), x_i)
            done = done | conv | (~inside)

        lin = l_i * (Ho * Wo) + y_i * Wo + x_i
        ok = cand & at(ok_f, lin)
        l_f = l_i.to(torch.float32) + at(lo_f, lin)
        y_f = y_i.to(torch.float32) + at(yo_f, lin)
        x_f = x_i.to(torch.float32) + at(xo_f, lin)
        resp = at(resp_f, lin)
        scale_mult = 2.0 ** (o + first_octave)
        x_img = x_f * scale_mult
        y_img = y_f * scale_mult
        size = sigma * torch.pow(2.0, l_f / n_layers) * scale_mult * 2.0
        m = 2.0
        ok = ok & (x_img >= m) & (x_img <= vw - 1 - m) \
            & (y_img >= m) & (y_img <= vh - 1 - m)

        all_resp.append(torch.where(ok, resp, torch.full_like(resp, -1.0)))
        all_xy.append(torch.stack([x_img, y_img], -1))
        all_size.append(size)
        all_valid.append(ok)
        all_oct.append(torch.full((N, budget), o, dtype=torch.int64,
                                  device=dev))
        all_layer.append(torch.clamp(torch.round(l_f), 1, n_layers)
                         .to(torch.int64))
        all_ypix.append(y_f)
        all_xpix.append(x_f)

    resp = torch.cat(all_resp, 1)
    top_resp, top_i = _topk_stable(resp, max_kp)

    def sel(parts):
        t = torch.cat(parts, 1)
        if t.dim() == 3:
            return torch.gather(t, 1, top_i[..., None].expand(-1, -1, t.shape[2]))
        return torch.gather(t, 1, top_i)
    sel_xy = sel(all_xy)
    sel_size = sel(all_size)
    sel_valid = sel(all_valid) & (top_resp > 0)
    sel_oct = sel(all_oct)
    sel_layer = sel(all_layer)
    sel_y = sel(all_ypix)
    sel_x = sel(all_xpix)

    # orientation + descriptor for every selected keypoint at once,
    # sampling bf16 gradients from the flat per-image pyramid
    flat = torch.cat([grad_stack(g).reshape(N, -1, 2) for g in gauss], 1)
    sizes_o = [int(np.prod(g.shape[1:])) for g in gauss]
    offs_o = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes_o)[:-1]]),
                             dtype=torch.int64, device=dev)
    Hs_o = torch.as_tensor([g.shape[2] for g in gauss], dtype=torch.int64,
                           device=dev)
    Ws_o = torch.as_tensor([g.shape[3] for g in gauss], dtype=torch.int64,
                           device=dev)
    pyr = (flat, offs_o[sel_oct], Hs_o[sel_oct], Ws_o[sel_oct])
    scl_octv = sel_size * 0.5 / torch.pow(
        2.0, sel_oct.to(torch.float32) + first_octave)

    angle = _orientation(pyr, sel_layer, sel_y, sel_x, scl_octv)
    desc = _descriptor(pyr, sel_layer, sel_y, sel_x, scl_octv, angle)

    l1 = torch.sum(torch.abs(desc), dim=-1, keepdim=True)
    desc = torch.sqrt(desc / torch.clamp(l1, min=1e-12))
    v = sel_valid[..., None]
    desc = torch.where(v, desc, torch.zeros_like(desc))
    return SiftFeatures(
        xy=torch.where(v, sel_xy, torch.zeros_like(sel_xy)),
        size=torch.where(sel_valid, sel_size, torch.zeros_like(sel_size)),
        response=torch.where(sel_valid, top_resp, torch.zeros_like(top_resp)),
        desc=desc,
        valid=sel_valid,
    )


def _upscaled_base(gray: torch.Tensor, sigma: float, upscale: bool):
    """The first octave's base of an (N, H, W) grayscale batch: x2 linear
    upscale (half-pixel centres, edge-clamped: the weights of
    jax.image.resize(..., "linear") for an exact x2) and the blur up to
    ``sigma``. Returns (base, first octave)."""
    N, H, W = gray.shape
    if upscale:
        base = F.interpolate(gray[:, None], size=(H * 2, W * 2),
                             mode="bilinear", align_corners=False)[:, 0]
        sig_diff = math.sqrt(max(sigma * sigma - 4 * 0.25, 0.01))
        first_octave = -1
    else:
        base = gray
        sig_diff = math.sqrt(max(sigma * sigma - 0.25, 0.01))
        first_octave = 0
    return _blur_multi(base, [sig_diff])[:, 0], first_octave


def extract_sift(img_gray: torch.Tensor, valid_hw: torch.Tensor,
                 max_kp: int = 1024, n_layers: int = 4,
                 contrast_thresh: float = 0.03, edge_thresh: float = 6.0,
                 sigma: float = 1.4142, upscale: bool = True
                 ) -> SiftFeatures:
    """Detect and describe the SIFT features of one (H, W) float32
    grayscale image on the 0..255 scale, whose content may fill only its
    top-left ``valid_hw`` = (h, w). Returns SiftFeatures without the batch
    dimension, in original-image pixel coordinates (not centre-shifted)."""
    base, first_octave = _upscaled_base(img_gray.to(torch.float32)[None],
                                        sigma, upscale)
    n_oct = _num_octaves(base.shape[1], base.shape[2])
    gauss = build_pyramid_batch(base, sigma, n_layers, n_oct)
    hw = torch.as_tensor(valid_hw, device=img_gray.device).reshape(1, 2)
    out = _sift_from_pyramid(gauss, hw,
                             max_kp, n_layers, contrast_thresh, edge_thresh,
                             sigma, first_octave)
    return SiftFeatures(*(t[0] for t in out))


def extract_sift_batch(imgs_u8: torch.Tensor, valid_hw: torch.Tensor,
                       max_kp: int = 1024, n_layers: int = 4,
                       contrast_thresh: float = 0.03,
                       edge_thresh: float = 6.0, sigma: float = 1.4142,
                       upscale: bool = True) -> SiftFeatures:
    """SIFT of an (N, H, W, 3) uint8 BGR batch (edge-padded to a common
    shape); ``valid_hw`` (N, 2) holds each image's true (h, w)."""
    N, H, W, _ = imgs_u8.shape
    b = imgs_u8[..., 0].to(torch.float32)
    g = imgs_u8[..., 1].to(torch.float32)
    r = imgs_u8[..., 2].to(torch.float32)
    gray = 0.114 * b + 0.587 * g + 0.299 * r
    base, first_octave = _upscaled_base(gray, sigma, upscale)
    n_oct = _num_octaves(base.shape[1], base.shape[2])
    gauss = build_pyramid_batch(base, sigma, n_layers, n_oct)
    return _sift_from_pyramid(gauss, valid_hw, max_kp, n_layers,
                              contrast_thresh, edge_thresh, sigma,
                              first_octave)
