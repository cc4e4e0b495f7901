"""Incremental bundle-adjustment stitching.

Port of simplepanorama_tpu/stitch.py (stch::bundleadjust_stitching of the
reference): nodes are added in greedy strongest-edge order; each new
camera inherits its connection's focal with the principal point zeroed
and a rotation initialized from the pairwise RANSAC homography (nearest
rotation to K_new^-1 H K_conn, times R_conn); after every addition a full
LM bundle adjustment runs over all cameras added so far; finally the
principal points are shifted by the integer image half-sizes.

Cameras are renumbered into addition order and matches sorted by
activation step, so the live subproblem after addition l is a prefix of
the padded tables. The schedule is split into equal-work chunks, each run
at a cropped capacity bucket (matches rounded to 2048, cameras to 8) —
the JAX package's bucket plan, here as a host loop over additions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simplepanorama_tpu_torch import ba
from simplepanorama_tpu_torch.adjacency import Adjacency
from simplepanorama_tpu_torch.config import Config
from simplepanorama_tpu_torch.geometry import rotation as rotn
from simplepanorama_tpu_torch.geometry.graph import (
    Component, order_nodes_by_connection)


@dataclasses.dataclass
class StitchResult:
    """Post-BA state (stch::stitch_result), component-local indexing."""
    rot: np.ndarray            # (n, 3, 3)
    K: np.ndarray              # (n, 3, 3), centers shifted by half-size
    adj: np.ndarray            # (n, n) upper-tri weights
    connectivity: np.ndarray   # (n,)
    order: List[Tuple[int, int]]  # [(node, connected_to)] local indices
    nodes: List[int]           # local -> global image index
    center: int                # best-connected local node
    sizes: List[Tuple[int, int]]  # (h, w) per local node


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def build_ba_data(comp: Component, adjres: Adjacency, device="cpu",
                  cap_round: int = 512,
                  order: Optional[List[Tuple[int, int]]] = None,
                  relabel: Optional[np.ndarray] = None,
                  ) -> Tuple[ba.BAData, Optional[np.ndarray]]:
    """Flatten the component's directed cleaned matches into padded
    tables on ``device``; with ``order``, matches are sorted by activation
    step and prefix[l] = matches active after addition l."""
    nodes = comp.nodes
    g2l = {g: l for l, g in enumerate(nodes)}
    mi, mj, q, t, step = [], [], [], [], []
    add_idx = None
    if order is not None:
        add_idx = {node: l for l, (node, _) in enumerate(order)}
    for (gi, gj), (xy_i, xy_j) in adjres.matches.items():
        if gi in g2l and gj in g2l:
            li, lj = g2l[gi], g2l[gj]
            mi.extend([li] * len(xy_i))
            mj.extend([lj] * len(xy_i))
            q.append(xy_i)
            t.append(xy_j)
            if add_idx is not None:
                s = max(add_idx.get(li, len(order)),
                        add_idx.get(lj, len(order)))
                step.extend([s] * len(xy_i))
    M = len(mi)
    mi_np = np.asarray(mi, np.int64)
    mj_np = np.asarray(mj, np.int64)
    q_np = np.concatenate(q).astype(np.float32) if M else np.zeros((0, 2), np.float32)
    t_np = np.concatenate(t).astype(np.float32) if M else np.zeros((0, 2), np.float32)
    prefix = None
    if add_idx is not None and M:
        step_np = np.asarray(step, np.int64)
        srt = np.argsort(step_np, kind="stable")
        mi_np, mj_np = mi_np[srt], mj_np[srt]
        q_np, t_np = q_np[srt], t_np[srt]
        prefix = np.searchsorted(step_np[srt], np.arange(len(order)),
                                 side="right")
    if relabel is not None and M:
        mi_np = relabel[mi_np].astype(np.int64)
        mj_np = relabel[mj_np].astype(np.int64)
    cap = max(cap_round, _round_up(M, cap_round))
    mi_a = np.zeros(cap, np.int64)
    mj_a = np.zeros(cap, np.int64)
    q_a = np.zeros((cap, 2), np.float32)
    t_a = np.zeros((cap, 2), np.float32)
    valid = np.zeros(cap, bool)
    mp_a = np.zeros(cap, np.int64)
    if M:
        mi_a[:M], mj_a[:M], q_a[:M], t_a[:M] = mi_np, mj_np, q_np, t_np
        valid[:M] = True
        uniq, inv_rows = np.unique(np.stack([mi_np, mj_np], 1), axis=0,
                                   return_inverse=True)
        mp_a[:M] = inv_rows.reshape(-1)
    else:
        uniq = np.zeros((0, 2), np.int64)
    P = max(64, _round_up(len(uniq), 64))
    pi_a = np.zeros(P, np.int64)
    pj_a = np.zeros(P, np.int64)
    pi_a[:len(uniq)] = uniq[:, 0]
    pj_a[:len(uniq)] = uniq[:, 1]
    T = lambda a: torch.as_tensor(a, device=device)
    data = ba.BAData(mi=T(mi_a), mj=T(mj_a), q=T(q_a), t=T(t_a),
                     m_valid=T(valid), pi=T(pi_a), pj=T(pj_a), mp=T(mp_a))
    return data, prefix


def _chunk_plan(prefix: np.ndarray, L: int, n_pad: int, Mcap: int):
    """Equal-work chunks of additions [lo, hi) with their capacity buckets
    (n_cap, m_cap), as stitch.bundle_adjust_stitching plans them."""
    n_chunks = min(10, L - 1)
    w = prefix[1:L].astype(np.float64) + 3000.0
    cw = np.cumsum(w)
    bounds = [1]
    for c in range(1, n_chunks):
        t = np.searchsorted(cw, cw[-1] * c / n_chunks) + 1
        if t > bounds[-1] and t < L:
            bounds.append(int(t))
    bounds.append(L)
    chunks = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        n_cap = min(n_pad, _round_up(hi, 8))
        m_cap = min(Mcap, _round_up(max(int(prefix[hi - 1]), 1), 2048))
        chunks.append((lo, hi, n_cap, m_cap))
    return chunks


def _add_camera(cams: ba.CamState, l: int, conn: int, H_pair: torch.Tensor):
    """Activate camera l (addition order) from its connection: inherit the
    focal, zero principal point, rotation from the pairwise homography."""
    f = cams.focal[conn]
    Kc = ba._K_of(f, cams.ppal[conn])
    Kn_inv = torch.diag(torch.stack([1.0 / f, 1.0 / f, torch.ones_like(f)]))
    R_init = rotn.orthogonalize(Kn_inv @ H_pair @ Kc)
    R_conn = rotn.rodrigues(cams.rotvec[conn])
    rv = rotn.rotvec_from_matrix(R_init @ R_conn)
    focal = cams.focal.clone()
    ppal = cams.ppal.clone()
    rotvec = cams.rotvec.clone()
    focal[l] = f
    ppal[l] = 0.0
    rotvec[l] = rv
    return cams._replace(focal=focal, ppal=ppal, rotvec=rotvec)


def _shift_centers(K: np.ndarray, sizes, nodes) -> np.ndarray:
    Ks = K.copy()
    for l in range(len(nodes)):
        h, w = sizes[nodes[l]]
        Ks[l, 0, 2] += w // 2
        Ks[l, 1, 2] += h // 2
    return Ks


def bundle_adjust_stitching(comp: Component, adjres: Adjacency,
                            sizes: Sequence[Tuple[int, int]], focal: float,
                            cfg: Config,
                            progress: Optional[Callable[[float], None]] = None,
                            cancelled: Optional[Callable[[], bool]] = None,
                            device="cpu") -> StitchResult:
    """Run the incremental BA over one connected component; ``sizes`` are
    (h, w) of the global image list, ``focal`` the scene estimate.
    ``cfg.fast`` selects the Lowe objective."""
    nodes = comp.nodes
    n = len(nodes)
    order = order_nodes_by_connection(comp.adj + comp.adj.T)
    center = int(np.argmax(comp.connectivity))
    rot = np.tile(np.eye(3), (n, 1, 1))
    K = np.tile(np.diag([focal, focal, 1.0]), (n, 1, 1))

    def result(K):
        return StitchResult(rot=rot, K=_shift_centers(K, sizes, nodes),
                            adj=comp.adj, connectivity=comp.connectivity,
                            order=order, nodes=nodes, center=center,
                            sizes=[sizes[g] for g in nodes])

    if n == 1 or len(order) < 2:
        return result(K)
    if cancelled is not None and cancelled():
        raise RuntimeError("Process canceled")

    L = len(order)
    in_order = [o[0] for o in order]
    seen = set(in_order)
    perm = np.array(in_order + [i for i in range(n) if i not in seen], np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    data, prefix = build_ba_data(comp, adjres, device=device, order=order,
                                 relabel=inv)
    Mcap = int(data.mi.shape[0])
    if prefix is None:
        prefix = np.zeros(L, np.int64)
    order_conns = [int(inv[max(o[1], 0)]) for o in order]
    H_pair = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    for l in range(1, L):
        node, conn = order[l]
        H_pair[l] = adjres.hom_mat[nodes[conn], nodes[node]].astype(np.float32)
    H_pair = torch.as_tensor(H_pair, device=device)
    # V-augment quirk: the scaling focal belongs to the active camera with
    # the highest ORIGINAL local index, renumbered
    vaug = inv[np.maximum.accumulate(np.array(in_order))]
    n_pad = _round_up(n, 8)
    cams = ba.CamState(
        focal=torch.full((n_pad,), focal, dtype=torch.float32, device=device),
        ppal=torch.zeros((n_pad, 2), dtype=torch.float32, device=device),
        rotvec=torch.zeros((n_pad, 3), dtype=torch.float32, device=device),
        b=data.t.clone())
    active = torch.zeros(n_pad, dtype=torch.bool, device=device)
    active[0] = True

    for lo, hi, n_cap, m_cap in _chunk_plan(prefix, L, n_pad, Mcap):
        sl = lambda x: x[:m_cap]
        data_c = ba.BAData(mi=sl(data.mi), mj=sl(data.mj), q=sl(data.q),
                           t=sl(data.t), m_valid=sl(data.m_valid),
                           pi=data.pi, pj=data.pj, mp=sl(data.mp))
        cams_c = ba.CamState(cams.focal[:n_cap], cams.ppal[:n_cap],
                             cams.rotvec[:n_cap], sl(cams.b))
        active_c = active[:n_cap].clone()
        for l in range(lo, hi):
            cams_c = _add_camera(cams_c, l, order_conns[l], H_pair[l])
            active_c[l] = True
            cams_c = ba.lm_run_impl(cams_c, data_c, active_c,
                                    float(cfg.lambda_), fast=bool(cfg.fast),
                                    vaug_idx=int(vaug[l])).cams
        cams = ba.CamState(
            focal=torch.cat([cams_c.focal, cams.focal[n_cap:]]),
            ppal=torch.cat([cams_c.ppal, cams.ppal[n_cap:]]),
            rotvec=torch.cat([cams_c.rotvec, cams.rotvec[n_cap:]]),
            b=torch.cat([cams_c.b, cams.b[m_cap:]]))
        active[:n_cap] = active_c
        if progress is not None:
            progress((hi - lo) / (L - 1))
        if cancelled is not None and cancelled():
            raise RuntimeError("Process canceled")

    focal_new = cams.focal.cpu().double().numpy()
    ppal_new = cams.ppal.cpu().double().numpy()
    rv_new = cams.rotvec.cpu().double().numpy()
    for l in range(L):   # addition order back to local ids
        i = int(perm[l])
        K[i] = np.array([[focal_new[l], 0, ppal_new[l, 0]],
                         [0, focal_new[l], ppal_new[l, 1]],
                         [0, 0, 1.0]])
        rot[i] = _rodrigues_np(rv_new[l])
    return result(K)


def _rodrigues_np(v: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(v)
    if th < 1e-10:
        return np.eye(3) + _skew(v)
    Kx = _skew(v / th)
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
