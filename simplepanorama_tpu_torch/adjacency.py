"""Pairwise match verification -> scene adjacency.

Port of simplepanorama_tpu/adjacency.py (util::adj_calculator of the
reference). Pairs are processed in fixed-size batches:

  pass 1  raw ratio-test match counts for all upper-triangular pairs;
          the compacted match tables stay on the device;
  filter  keep the top ``max_images_per_match`` candidates per row;
  pass 2  per surviving pair: RANSAC homography, inlier count, overlap
          acceptance both ways, cleaned top-``max_keypoints`` matches.

Adjacency weight of an accepted pair = overlap fraction.

RANSAC draws come from ``pair_draws(i, j, n_iter, m)``: by default a
``torch.Generator`` seeded from (seed, i, j), so a pair's draws depend on
its identity alone; tests replace the hook to inject JAX's draws.

In a world of several ranks (parallel.mesh.pipeline_mesh) each pass takes
this rank's contiguous shard of its pair list, padded with repeats of its
last pair so that every rank runs the same shapes, and all-gathers its
results (the counts; the verification outputs), as the JAX package's
multi-process passes do. Pass 2 then matches its pairs again, since
their pass-1 tables may live on another rank. Every rank ends with the
same Adjacency.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from simplepanorama_tpu_torch.config import Config
from simplepanorama_tpu_torch.ops.homography import (
    ransac_homography, inlier_distances)
from simplepanorama_tpu_torch.ops.matching import (
    match_pair_batch, gather_match_coords)
from simplepanorama_tpu_torch.ops.polygon import overlap_stats

_MIN_RAW_MATCHES = 30  # match_quality requires >= 30 raw matches


@dataclasses.dataclass
class Adjacency:
    """Scene graph produced by pairwise verification."""
    adj: np.ndarray        # (N, N) upper-tri weights (overlap), 0 = rejected
    raw_counts: np.ndarray  # (N, N) pass-1 ratio-test match counts
    hom_mat: np.ndarray    # (N, N, 3, 3); [i, j] maps image-j pts -> image-i
    # cleaned matches per accepted ordered pair: (i, j) -> (xy_i, xy_j)
    matches: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)


def torch_pair_draws(seed: int, n_images: int, device) -> Callable:
    """Default RANSAC draw stream: uniforms from a generator seeded by the
    pair's linear index, so chunking cannot change a pair's draws. The
    generator is the CPU's on every device (CUDA's Philox stream differs),
    so a stitch draws the same samples on the CPU and on the card."""
    def draws(i: int, j: int, n_iter: int, m: int) -> torch.Tensor:
        g = torch.Generator()
        g.manual_seed(seed * n_images * n_images + i * n_images + j)
        return torch.rand((n_iter, m), generator=g).to(device)
    return draws


def _verify_core(q, t, match_valid, xy_q, xy_t, valid_q, valid_t,
                 hw_q, hw_t, draws, n_raw, keep_cap: int, margin,
                 min_overlap, overlap_inl_match, overlap_inl_keyp, conf):
    """RANSAC + overlap acceptance for a batch of pairs whose 2-NN match
    coordinates are gathered. Returns per-pair (accept, weight, H, kq, kt,
    keep_valid)."""
    H, inl = ransac_homography(q, t, match_valid, hw_q, hw_t, draws,
                               margin=margin)
    H = H / H[:, 2:3, 2:3]
    n_in = inl.sum(-1)
    Hinv = torch.linalg.inv(H)
    ov1, akp1, am1 = overlap_stats(H, hw_q, hw_t, xy_q, valid_q, q, match_valid)
    ov2, akp2, am2 = overlap_stats(Hinv, hw_t, hw_q, xy_t, valid_t, t,
                                   match_valid)

    f = lambda a, b: a.to(torch.float32) / b.to(torch.float32)
    oim1, oik1 = f(n_in, am1), f(n_in, akp1)
    oim2, oik2 = f(n_in, am2), f(n_in, akp2)
    accept = ((n_raw >= _MIN_RAW_MATCHES)
              & (oim1 <= 1.0) & (ov1 >= min_overlap)
              & (oim1 >= overlap_inl_match) & (oik1 >= overlap_inl_keyp)
              & (oim2 <= 1.0) & (ov2 >= min_overlap)
              & (oim2 >= overlap_inl_match) & (oik2 >= overlap_inl_keyp)
              # the reference averages the second direction with itself
              & ((oik2 + oik2) * 0.5 >= conf))

    # clean_matches: inliers within margin ranked by reprojection distance
    d = inlier_distances(H, q, t, match_valid)
    neg, order = torch.sort(-d, dim=1, descending=True, stable=True)
    dk, order = -neg[:, :keep_cap], order[:, :keep_cap]
    keep_valid = torch.isfinite(dk) & (dk <= margin) & accept[:, None]
    oi = order[..., None].expand(-1, -1, 2)
    kq = torch.gather(q, 1, oi)
    kt = torch.gather(t, 1, oi)
    weight = torch.where(accept, ov1, torch.zeros_like(ov1))
    return accept, weight, H, kq, kt, keep_valid


def _stack_features(feats):
    batch = getattr(feats, "device_batch", None)
    if batch is not None:
        return batch
    xy = torch.as_tensor(np.stack([np.asarray(f.xy) for f in feats]))
    desc = torch.as_tensor(np.stack([np.asarray(f.desc) for f in feats]))
    valid = torch.as_tensor(np.stack([np.asarray(f.valid) for f in feats]))
    return xy, desc, valid


def _pair_shard(pairs, mesh):
    """This rank's contiguous shard of ``pairs``, padded with repeats of
    its last pair (or of the list's) to ceil(len / ranks); no mesh: the
    whole list."""
    if mesh is None or not pairs:
        return list(pairs)
    from simplepanorama_tpu_torch.parallel.multihost import host_shard
    per = (len(pairs) + mesh.size - 1) // mesh.size
    mine = host_shard(pairs, mesh.size, mesh.rank)
    return mine + [mine[-1] if mine else pairs[-1]] * (per - len(mine))


def _gather_pairs(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The per-pair results of every rank's shard, in pair order (first
    ``n``); no mesh: ``x``."""
    if mesh is None:
        return x
    from simplepanorama_tpu_torch.parallel.mesh import all_gather_cat
    return all_gather_cat(x, mesh)[:n]


def raw_match_counts(feats, cfg: Config, chunk: int = 64,
                     progress: Optional[Callable[[float], None]] = None,
                     cancelled: Optional[Callable[[], bool]] = None):
    """Pass 1: ratio-test match counts for all upper-triangular pairs.
    Returns (counts (N, N), device tables (match_idx, match_valid, n_raw)
    with pair k of the upper-triangular order at row k). In a world of
    several ranks each rank counts its shard of the pairs, the counts are
    all-gathered, and the tables (this rank's pairs only) are None."""
    from simplepanorama_tpu_torch.parallel.mesh import pipeline_mesh
    n = len(feats)
    counts = np.zeros((n, n))
    all_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    mesh = pipeline_mesh()
    pairs = _pair_shard(all_pairs, mesh)
    xy, desc, valid = _stack_features(feats)
    total = max(1, len(pairs))
    tabs = []
    for s in range(0, len(pairs), chunk):
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        blk = pairs[s:s + chunk]
        qi = torch.as_tensor([p[0] for p in blk], device=desc.device)
        ti = torch.as_tensor([p[1] for p in blk], device=desc.device)
        tabs.append(match_pair_batch(desc[qi], desc[ti], valid[qi], valid[ti],
                                     cfg.max_matches_per_pair))
        if progress is not None:
            progress(len(blk) / total)
    if not tabs:
        return counts, None
    mi, mv, nm = (torch.cat(t) for t in zip(*tabs))
    for (i, j), c in zip(all_pairs,
                         _gather_pairs(nm, mesh, len(all_pairs)).tolist()):
        counts[i, j] = float(c)
    return counts, (None if mesh is not None else (mi, mv, nm))


def heuristic_match_filter(counts: np.ndarray, n: int) -> np.ndarray:
    """Keep the top-n candidates per row of the upper triangle
    (heuristic_match_filter, _homography.cpp:837-878)."""
    size = counts.shape[0]
    if n <= 0 or size == 0:
        raise ValueError("Wrong parameter or empty matches")
    n = min(n, size)
    out = np.zeros_like(counts)
    for i in range(size):
        cand = [(counts[i, j], j) for j in range(i + 1, size)]
        cand.sort(key=lambda p: p[0], reverse=True)
        for v, j in cand[:n]:
            out[i, j] = v
    return out


def build_adjacency(feats, sizes: Sequence[Tuple[int, int]], cfg: Config,
                    seed: int = 0, chunk: int = 32,
                    progress: Optional[Callable[[float], None]] = None,
                    cancelled: Optional[Callable[[], bool]] = None,
                    pair_draws: Optional[Callable] = None) -> Adjacency:
    """Full two-pass adjacency computation (panorama::get_adj_par)."""
    from simplepanorama_tpu_torch.parallel.mesh import pipeline_mesh
    n = len(feats)
    counts, tables = raw_match_counts(
        feats, cfg, chunk=64,
        progress=(lambda d: progress(d * 0.5)) if progress else None,
        cancelled=cancelled)
    filtered = heuristic_match_filter(counts, cfg.max_images_per_match)

    adj = np.zeros((n, n))
    hom = np.zeros((n, n, 3, 3))
    hom[:] = np.eye(3)
    result = Adjacency(adj=adj, raw_counts=counts, hom_mat=hom)

    pair_pos = {p: k for k, p in enumerate(
        (i, j) for i in range(n) for j in range(i + 1, n))}
    all_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                 if filtered[i, j] >= _MIN_RAW_MATCHES]
    if not all_pairs:
        return result
    mesh = pipeline_mesh()
    pairs = _pair_shard(all_pairs, mesh)

    xy, desc, valid = _stack_features(feats)
    dev = xy.device
    if pair_draws is None:
        pair_draws = torch_pair_draws(seed, n, dev)
    hw = torch.as_tensor(np.array(sizes, np.int64), device=dev)
    M = cfg.max_matches_per_pair
    total = len(pairs)
    outs = []
    for s in range(0, len(pairs), chunk):
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")
        blk = pairs[s:s + chunk]
        qi = torch.as_tensor([p[0] for p in blk], device=dev)
        ti = torch.as_tensor([p[1] for p in blk], device=dev)
        rows = torch.as_tensor([pair_pos[p] for p in blk], device=dev)
        draws = torch.stack([torch.as_tensor(
            pair_draws(i, j, cfg.RANSAC_iterations, M), dtype=torch.float32,
            device=dev) for i, j in blk])
        if tables is not None:
            mi_tab, mv_tab, nm_tab = tables
            match_idx, match_valid, n_raw = (mi_tab[rows], mv_tab[rows],
                                             nm_tab[rows])
        else:
            # the pass-1 tables of these pairs may be on another rank
            match_idx, match_valid, n_raw = match_pair_batch(
                desc[qi], desc[ti], valid[qi], valid[ti],
                cfg.max_matches_per_pair)
        q, t = gather_match_coords(xy[qi], xy[ti], match_idx, match_valid)
        out = _verify_core(
            q, t, match_valid, xy[qi], xy[ti], valid[qi], valid[ti],
            hw[qi], hw[ti], draws, n_raw,
            keep_cap=cfg.max_keypoints, margin=float(cfg.x_margin),
            min_overlap=cfg.min_overlap,
            overlap_inl_match=cfg.overlap_inl_match,
            overlap_inl_keyp=cfg.overlap_inl_keyp, conf=cfg.conf)
        outs.append(out)
        if progress is not None:
            progress(len(blk) / total * 0.5)
    accept, weight, H, kq, kt, kv = (
        _gather_pairs(torch.cat(x), mesh, len(all_pairs)).cpu().numpy()
        for x in zip(*outs))
    for b, (i, j) in enumerate(all_pairs):
        if not accept[b]:
            continue
        adj[i, j] = weight[b]
        hom[i, j] = H[b]
        hom[j, i] = np.linalg.inv(H[b])
        m = kv[b]
        result.matches[(i, j)] = (kq[b][m], kt[b][m])
        result.matches[(j, i)] = (kt[b][m], kq[b][m])
    return result
