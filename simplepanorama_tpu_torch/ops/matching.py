"""Descriptor matching: all-pairs 2-NN + Lowe ratio test.

Port of simplepanorama_tpu/ops/matching.py (util::match_keypoints of the
reference: FLANN 2-NN + ratio 0.8). rootSIFT descriptors are unit-L2, so
dist^2 = 2 - 2 dot and the 2-NN is a top-2 over one batched matmul.
"""

from __future__ import annotations

from typing import Tuple

import torch

RATIO_THRESH = 0.8


def match_pair_batch(desc_q: torch.Tensor, desc_t: torch.Tensor,
                     valid_q: torch.Tensor, valid_t: torch.Tensor,
                     match_cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-NN ratio matching for a batch of B image pairs.

    desc_q/desc_t: (B, K, 128) rootSIFT; valid_q/valid_t: (B, K) bool.
    Returns (match_idx (B, match_cap, 2) (queryIdx, trainIdx) compacted to
    the front and padded with -1, match_valid (B, match_cap) bool,
    n_matches (B,) raw ratio-test counts)."""
    dots = torch.einsum("bqd,btd->bqt", desc_q, desc_t)
    neg_inf = torch.full_like(dots, -float("inf"))
    dots = torch.where(valid_t[:, None, :], dots, neg_inf)
    best, best_idx = torch.max(dots, dim=2)    # first maximal index
    t_iota = torch.arange(dots.shape[2], device=dots.device)
    second = torch.max(torch.where(t_iota == best_idx[..., None], neg_inf,
                                   dots), dim=2).values
    d0 = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    d1 = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=0.0))
    ok = (d0 < RATIO_THRESH * d1) & valid_q
    ok = ok & (valid_t.sum(dim=1) >= 2)[:, None]
    n_matches = ok.sum(dim=1).to(torch.int32)

    # compact passing queries to the front, stable by query index
    order = torch.argsort((~ok).to(torch.uint8), dim=1, stable=True)
    order = order[:, :match_cap]
    sel_ok = torch.gather(ok, 1, order)
    q_idx = torch.where(sel_ok, order, -1)
    t_idx = torch.where(sel_ok, torch.gather(best_idx, 1, order), -1)
    match_idx = torch.stack([q_idx, t_idx], -1).to(torch.int32)
    return match_idx, sel_ok, n_matches


def gather_match_coords(kp_xy_q: torch.Tensor, kp_xy_t: torch.Tensor,
                        match_idx: torch.Tensor, match_valid: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, M, 2) query/train coordinates of compacted matches."""
    def take(xy, idx):
        i = torch.clamp(idx, min=0).to(torch.int64)[..., None].expand(-1, -1, 2)
        v = torch.gather(xy, 1, i)
        return torch.where(match_valid[..., None], v, torch.zeros_like(v))
    return take(kp_xy_q, match_idx[..., 0]), take(kp_xy_t, match_idx[..., 1])
