"""Exposure-disparity fix (the reference's "test" namespace —
test::equalizeIntensities / adjust_intensity, reference src/test/
_test.cpp:9-122; this is the README's exposure feature, not a test suite).

At half resolution: per-image gray intensity weighted by its distance
transform; each image accumulates its overlapping neighbors' weighted
intensities and weights (over ROI-rect overlaps, inside its own mask);
the correction field is own_intensity / (blended mean + eps) + eps, with
1.0 outside the mask, Gaussian-smoothed 13x13 sigma 7. Applied at blend
time by resizing to the image and dividing channel-wise.

The neighbor accumulation is one canvas sum of all weighted intensities /
weights, then per-image slice — O(N) instead of the reference's O(N^2)
ROI pair loop. The correction-field computation itself lives on-device in
render.compose.equalize_dev; this module keeps the host-side application
(adjust_intensity, used by the full-res re-render) and straightening.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def adjust_intensity(images: Sequence[np.ndarray],
                     fields: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Divide each image by its (resized) correction field
    (test::adjust_intensity). Images float 0..255; output same scale."""
    import cv2
    out = []
    for im, f in zip(images, fields):
        fr = cv2.resize(f, (im.shape[1], im.shape[0]),
                        interpolation=cv2.INTER_LINEAR)
        fr = np.where(np.abs(fr) < 1e-6, 1.0, fr)
        out.append(im / fr[..., None])
    return out


def straighten(rotations: np.ndarray) -> np.ndarray:
    """Brown-Lowe auto-straightening (strg::straightenPanorama,
    reference src/math/_straightening.cpp:5-51): covariance of
    camera X axes, up-vector = smallest eigenvector sign-aligned to world
    up, global rotation aligning it to (0,1,0)."""
    X = rotations[:, :, 0]                     # camera X axes (N,3)
    C = X.T @ X
    wvals, wvecs = np.linalg.eigh(C)
    up = wvecs[:, 0]
    world_up = np.array([0.0, 1.0, 0.0])
    if up @ world_up < 0:
        up = -up
    w = np.cross(up, world_up)
    s = np.linalg.norm(w)
    c = up @ world_up
    if s < 1e-12:
        return rotations.copy()
    V = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    g = np.eye(3) + V + V @ V * ((1 - c) / (s * s))
    return np.einsum("ab,nbc->nac", g, rotations)
