"""The plain reference of the stitcher's cells: the true geometry.

Every view of a cell is cut out of one 360-degree equirectangular photo
(``panobench/data/FKH360_300.jpg``) by a pinhole camera whose yaw, roll,
focal length and exposure gain the benchmark drew from its seed. So the
right answer of a stitch is known without running any stitcher: the true
cameras, and the true panorama, which is the source photo itself seen
through the panorama's projection. This module works both out from the
drawn parameters alone, in float64, with plain NumPy and PyTorch. It
imports nothing of the program under test; it reads the program's
outputs (cameras, preview, full-res panorama, seam masks) only to judge
them.

Conventions (those the program's outputs are stated in):
- a camera maps an image pixel ``p`` to the world ray ``R @ inv(K) @ p``
  (``R`` camera to world, pixel centres at integer coordinates);
- the world's longitude is ``atan2(x, z)`` and its latitude
  ``atan2(y, hypot(x, z))``, ``y`` pointing down;
- a spherical canvas pixel ``(x, y)`` of a panorama with scale ``s`` and
  origin ``(x0, y0)`` is the ray of ``u = (x + x0) / s``,
  ``v = (y + y0) / s``: ``(sin v sin u, -cos v, sin v cos u)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def focal_px(size: int, hfov_deg: float) -> float:
    """Focal length in px of a square ``size``-px view of ``hfov_deg``."""
    return (size / 2.0) / math.tan(math.radians(hfov_deg) / 2.0)


def true_rotations(yaw_deg: Sequence[float],
                   roll_deg: Sequence[float]) -> np.ndarray:
    """(n, 3, 3) camera-to-world rotations: roll about the optical axis,
    then yaw about the vertical."""
    return np.stack([rot_y(math.radians(y)) @ rot_z(math.radians(r))
                     for y, r in zip(yaw_deg, roll_deg)])


def true_K(size: int, hfov_deg: float, work: int) -> np.ndarray:
    """The true intrinsics of a ``size``-px view after the stitcher's
    resize to ``work`` px (pixel centres kept: ``(u + .5) s - .5``)."""
    s = work / size
    f = focal_px(size, hfov_deg) * s
    c = (size - 1) / 2.0
    c = (c + 0.5) * s - 0.5
    return np.array([[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]])


def loop_pairs(n: int, yaw_step_deg: float) -> List[Tuple[int, int]]:
    """The pairs of neighbouring views: (k, k + 1), and (n - 1, 0) when
    the views close the circle."""
    pairs = [(k, k + 1) for k in range(n - 1)]
    if n > 2 and n * yaw_step_deg >= 360.0 - 1e-9:
        pairs.append((n - 1, 0))
    return pairs


def _project(K: np.ndarray, rays: np.ndarray) -> np.ndarray:
    q = rays @ K.T
    return q[:, :2] / q[:, 2:3]


def registration_px(R_prog: np.ndarray, K_prog: np.ndarray,
                    R_true: np.ndarray, K_true: np.ndarray,
                    work: int, pairs: Sequence[Tuple[int, int]],
                    grid: int = 24, margin: float = 8.0) -> Dict[str, float]:
    """How far the program's cameras put each view's pixels from where
    they truly fall in its neighbour, in working-resolution px.

    ``R_prog``, ``K_prog`` hold one camera per view (global index; NaN
    for a view the program did not connect). For each neighbouring pair
    (i, j), a grid of pixels of view i that truly land inside view j
    (``margin`` px in) is mapped into j by the true cameras and by the
    program's; the pair's reading is the median distance. Returns the
    worst pair's median (``worst``; inf where a view of a pair is
    missing) and the median over pairs (``median``)."""
    t = (np.arange(grid) + 0.5) * (work / grid) - 0.5
    px = np.stack(np.meshgrid(t, t), -1).reshape(-1, 2)
    ph = np.concatenate([px, np.ones((len(px), 1))], 1)
    per_pair = []
    for i, j in pairs:
        if not (np.isfinite(R_prog[i]).all() and np.isfinite(R_prog[j]).all()):
            per_pair.append(math.inf)
            continue
        rays_t = ph @ (R_true[j].T @ R_true[i] @ np.linalg.inv(K_true)).T
        front = rays_t[:, 2] > 1e-6
        q_t = _project(K_true, rays_t[front])
        inside = ((q_t >= margin) & (q_t <= work - 1 - margin)).all(1)
        if not inside.any():
            continue
        src = ph[front][inside]
        q_t = q_t[inside]
        M = R_prog[j].T @ R_prog[i] @ np.linalg.inv(K_prog[i])
        rays_p = src @ M.T
        if (rays_p[:, 2] <= 1e-6).any():
            per_pair.append(math.inf)
            continue
        q_p = _project(K_prog[j], rays_p)
        per_pair.append(float(np.median(np.linalg.norm(q_p - q_t, axis=1))))
    if not per_pair:
        return {"worst": math.inf, "median": math.inf}
    return {"worst": float(max(per_pair)),
            "median": float(np.median(per_pair))}


def equirect_sample(src: torch.Tensor, lon: torch.Tensor,
                    lat: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an equirectangular photo (H, W, C) at world
    longitudes and latitudes (radians): columns wrap round the circle,
    rows are clamped (the photo's edge replicated), pixel centres at
    integer coordinates. Returns (..., C) in ``src``'s dtype."""
    H, W = src.shape[:2]
    px_per_rad = W / (2 * math.pi)
    x = torch.remainder(lon * px_per_rad, W)
    y = H / 2.0 + lat * px_per_rad
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f).to(src.dtype)[..., None]
    fy = (y - y0f).to(src.dtype)[..., None]
    x0 = x0f.long() % W
    x1 = (x0 + 1) % W
    y0 = y0f.long().clamp(0, H - 1)
    y1 = (y0f.long() + 1).clamp(0, H - 1)
    a = src[y0, x0] * (1 - fx) + src[y0, x1] * fx
    b = src[y1, x0] * (1 - fx) + src[y1, x1] * fx
    return a * (1 - fy) + b * fy


def view_rays(size: int, hfov_deg: float, R: np.ndarray, device,
              dtype=torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    """World longitude and latitude of every pixel of a square view."""
    f = focal_px(size, hfov_deg)
    c = (size - 1) / 2.0
    t = (torch.arange(size, device=device, dtype=dtype) - c) / f
    yc, xc = torch.meshgrid(t, t, indexing="ij")
    Rt = torch.as_tensor(R, device=device, dtype=dtype)
    X = Rt[0, 0] * xc + Rt[0, 1] * yc + Rt[0, 2]
    Y = Rt[1, 0] * xc + Rt[1, 1] * yc + Rt[1, 2]
    Z = Rt[2, 0] * xc + Rt[2, 1] * yc + Rt[2, 2]
    return torch.atan2(X, Z), torch.atan2(Y, torch.sqrt(X * X + Z * Z))


def canvas_rays(hw: Tuple[int, int], origin: Tuple[float, float],
                scale: float, device) -> Tuple[torch.Tensor, ...]:
    """The rays (x, y, z) of every pixel of a spherical canvas, in the
    world of the cameras the canvas was drawn with."""
    h, w = hw
    u = (torch.arange(w, device=device, dtype=torch.float64)
         + origin[0]) / scale
    v = (torch.arange(h, device=device, dtype=torch.float64)
         + origin[1]) / scale
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return (torch.sin(vv) * torch.sin(uu), -torch.cos(vv),
            torch.sin(vv) * torch.cos(uu))


def reference_panorama(src: torch.Tensor, hw, origin, scale,
                       R_prog: np.ndarray, K_prog: np.ndarray,
                       R_true: np.ndarray, K_true: np.ndarray, work: int,
                       margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the program's canvas should show, given its own cameras.

    Each canvas pixel's ray goes through the program's camera of the
    view that sees it farthest inside its border (at least ``margin``
    working px): that is the view pixel the panorama shows there. Its
    colour is the true colour of that view pixel, looked up in the
    source photo through the view's true camera (``K_true`` at the
    working resolution ``work``), without the view's exposure gain.
    Returns the (h, w, 3) float64 panorama and the mask of the pixels
    some view sees. Views the program left out (NaN cameras) are not
    used."""
    dev = src.device
    x, y, z = canvas_rays(hw, origin, scale, dev)
    best = torch.full(hw, -1.0, dtype=torch.float64, device=dev)
    X = torch.zeros(hw, dtype=torch.float64, device=dev)
    Y = torch.zeros_like(X)
    Z = torch.ones_like(X)
    Kt_inv = np.linalg.inv(K_true)
    for k in range(len(R_true)):
        if not np.isfinite(R_prog[k]).all():
            continue
        M = torch.as_tensor(K_prog[k] @ R_prog[k].T, device=dev)
        pz = M[2, 0] * x + M[2, 1] * y + M[2, 2] * z
        zs = torch.where(pz > 1e-9, pz, torch.ones_like(pz))
        px = (M[0, 0] * x + M[0, 1] * y + M[0, 2] * z) / zs
        py = (M[1, 0] * x + M[1, 1] * y + M[1, 2] * z) / zs
        inside = torch.minimum(torch.minimum(px, work - 1 - px),
                               torch.minimum(py, work - 1 - py))
        inside = torch.where(pz > 1e-9, inside, torch.full_like(inside, -1))
        take = (inside >= margin) & (inside > best)
        best = torch.where(take, inside, best)
        T = torch.as_tensor(R_true[k] @ Kt_inv, device=dev)
        X = torch.where(take, T[0, 0] * px + T[0, 1] * py + T[0, 2], X)
        Y = torch.where(take, T[1, 0] * px + T[1, 1] * py + T[1, 2], Y)
        Z = torch.where(take, T[2, 0] * px + T[2, 1] * py + T[2, 2], Z)
    lon = torch.atan2(X, Z)
    lat = torch.atan2(Y, torch.sqrt(X * X + Z * Z))
    img = equirect_sample(src.to(torch.float64), lon, lat)
    return img, best >= margin


def gray(img: torch.Tensor) -> torch.Tensor:
    """BGR (h, w, 3) to luma, float64."""
    img = img.to(torch.float64)
    return 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]


def ncc_gap(prog: torch.Tensor, ref: torch.Tensor,
            mask: torch.Tensor) -> float:
    """1 - the normalised cross-correlation of two luma images over
    ``mask``: 0 for images equal up to a gain and an offset. A pixel the
    program left black inside the mask counts as black."""
    a = prog[mask]
    b = ref[mask]
    if a.numel() < 2:
        return math.inf
    a = a - a.mean()
    b = b - b.mean()
    den = torch.sqrt((a * a).sum() * (b * b).sum())
    if float(den) == 0.0:
        return math.inf
    return float(1.0 - (a * b).sum() / den)


def seam_defect(seams: np.ndarray, masks: np.ndarray, offs: np.ndarray,
                canvas_hw: Tuple[int, int]) -> float:
    """Share of the canvas pixels covered by some image's footprint that
    the seam masks do not give to exactly one image, plus the seam
    pixels that lie outside their own footprint. ``seams`` and ``masks``
    are (N, Hb, Wb) bool blocks placed at ``offs`` (N, 2) = (y, x)."""
    h, w = canvas_hw
    cover = np.zeros((h, w), np.int32)
    owners = np.zeros((h, w), np.int32)
    outside = 0
    for s, m, (oy, ox) in zip(seams, masks, offs):
        bh = min(s.shape[0], h - oy)
        bw = min(s.shape[1], w - ox)
        s = s[:bh, :bw]
        m = m[:bh, :bw]
        outside += int((s & ~m).sum())
        cover[oy:oy + bh, ox:ox + bw] += m
        owners[oy:oy + bh, ox:ox + bw] += s
    covered = cover > 0
    n = int(covered.sum())
    if n == 0:
        return math.inf
    bad = int((covered & (owners != 1)).sum()) + outside
    return bad / n
