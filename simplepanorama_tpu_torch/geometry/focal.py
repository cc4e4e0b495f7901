"""Focal estimation from pairwise homographies (Shum & Szeliski).

Behavior matches util::focal_from_hom (reference src/system/
_util.cpp:482-542): per accepted pair, two candidate focals f0/f1 from the
homography entries; keep sqrt(f0*f1) when both succeed; final estimate is
the mean over pairs, rejected (returns -1) when NaN or < 300.

Host-side NumPy — the input is a tiny (N,N,3,3) table.
"""

from __future__ import annotations

import numpy as np


def focal_from_single_hom(H: np.ndarray):
    """Returns (f_geometric_mean or None)."""
    h = H
    # f1 from the bottom-row relations
    f1_ok = True
    d1 = h[2, 0] * h[2, 1]
    d2 = (h[2, 1] - h[2, 0]) * (h[2, 1] + h[2, 0])
    with np.errstate(divide="ignore", invalid="ignore"):
        v1 = -(h[0, 0] * h[0, 1] + h[1, 0] * h[1, 1]) / d1
        v2 = (h[0, 0] ** 2 + h[1, 0] ** 2 - h[0, 1] ** 2 - h[1, 1] ** 2) / d2
    if v1 < v2:
        v1, v2 = v2, v1
    if v1 > 0 and v2 > 0:
        f1 = np.sqrt(v1 if abs(d1) > abs(d2) else v2)
    elif v1 > 0:
        f1 = np.sqrt(v1)
    else:
        f1_ok = False

    f0_ok = True
    d1 = h[0, 0] * h[1, 0] + h[0, 1] * h[1, 1]
    d2 = h[0, 0] ** 2 + h[1, 0] ** 2 - h[0, 1] ** 2 - h[1, 1] ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        v1 = -h[0, 2] * h[1, 2] / d1
        v2 = (h[1, 2] ** 2 - h[0, 2] ** 2) / d2
    if v1 < v2:
        v1, v2 = v2, v1
    if v1 > 0 and v2 > 0:
        f0 = np.sqrt(v1 if abs(d1) > abs(d2) else v2)
    elif v1 > 0:
        f0 = np.sqrt(v1)
    else:
        f0_ok = False

    if f0_ok and f1_ok:
        return float(np.sqrt(f0 * f1))
    return None


def focal_from_hom(hom_mat: np.ndarray, adj: np.ndarray) -> float:
    """Mean focal over upper-triangular accepted pairs; -1 on failure."""
    n = adj.shape[0]
    focals = []
    for i in range(n):
        for j in range(i, n):
            if i != j and adj[i, j] > 0:
                f = focal_from_single_hom(hom_mat[i, j])
                if f is not None:
                    focals.append(f)
    if not focals:
        return -1.0
    mean = float(np.mean(focals))
    if not np.isfinite(mean) or mean < 300:
        return -1.0
    return mean
