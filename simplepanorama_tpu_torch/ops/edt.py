"""Euclidean distance transform by jump flooding (JFA).

Port of simplepanorama_tpu/ops/edt.py (the reference uses
cv::distanceTransform(DIST_L2, DIST_MASK_5)). Same passes, same
wrap-around neighbour access (torch.roll), so results equal the JAX
package's; a leading batch dimension is allowed.
"""

from __future__ import annotations

import math

import torch

_BIG = 1e10


def distance_transform(mask: torch.Tensor) -> torch.Tensor:
    """L2 distance of each nonzero pixel to the nearest zero pixel.

    mask: (..., H, W) bool or numeric. Returns float32 distances (0 on
    background)."""
    H, W = mask.shape[-2:]
    fg = mask.to(torch.bool)
    yy = torch.arange(H, dtype=torch.float32, device=mask.device)[:, None] \
        .expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=mask.device)[None, :] \
        .expand(H, W)
    big = torch.full_like(fg, _BIG, dtype=torch.float32)
    sy = torch.where(fg, big, yy)
    sx = torch.where(fg, big, xx)

    def dist2(sy, sx):
        return (sy - yy) ** 2 + (sx - xx) ** 2

    n_steps = max(1, int(math.ceil(math.log2(max(H, W)))))
    step = 1 << (n_steps - 1)
    for _ in range(n_steps + 1):
        best = dist2(sy, sx)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                cy = torch.roll(sy, (dy, dx), dims=(-2, -1))
                cx = torch.roll(sx, (dy, dx), dims=(-2, -1))
                d = dist2(cy, cx)
                take = d < best
                sy = torch.where(take, cy, sy)
                sx = torch.where(take, cx, sx)
                best = torch.where(take, d, best)
        step = max(1, step // 2)
    return torch.where(fg, torch.sqrt(best), torch.zeros_like(best))
