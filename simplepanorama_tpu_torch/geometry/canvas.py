"""Panorama canvas math: bounding boxes, translations, flat-plane chains.

Host-side (tiny-N metadata): util::get_pan_dimension (_util.cpp:204-231),
util::get_translation (_util.cpp:313-341), and the flat-panorama transform
prep of imgm::calc_stitch_from_adj (_img_manipulation.cpp:281-390).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PanSize:
    width: int
    height: int
    min_x: int
    min_y: int
    max_x: int
    max_y: int


def get_pan_dimension(top_lefts: Sequence[Tuple[int, int]],
                      sizes: Sequence[Tuple[int, int]]) -> PanSize:
    """Union bounding box of placed images. ``sizes`` are (h, w) per image."""
    min_x = min_y = np.iinfo(np.int64).max
    max_x = max_y = np.iinfo(np.int64).min
    for (tx, ty), (h, w) in zip(top_lefts, sizes):
        min_x = min(min_x, tx)
        min_y = min(min_y, ty)
        max_x = max(max_x, tx + w)
        max_y = max(max_y, ty + h)
    return PanSize(max_x - min_x, max_y - min_y, min_x, min_y, max_x, max_y)


def apply_h_np(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Perspective-transform (N,2) points by a 3x3 homography (host)."""
    p = np.concatenate([pts, np.ones((pts.shape[0], 1), pts.dtype)], axis=1)
    q = p @ H.T
    return q[:, :2] / q[:, 2:3]


def get_translation(base_hw: Tuple[int, int], attach_hw: Tuple[int, int],
                    H: np.ndarray):
    """Warped-corner bounding box + translation matrix
    (util::get_translation, _util.cpp:313-341). Returns (T, xstart, xend,
    ystart, yend) where T shifts the union box to positive coords."""
    ah, aw = attach_hw
    bh, bw = base_hw
    cor = np.array([[0, 0], [0, ah], [aw, 0], [aw, ah]], dtype=np.float64)
    cor = apply_h_np(H, cor)
    xstart = min(cor[0, 0], cor[1, 0], 0.0)
    xend = max(cor[2, 0], cor[3, 0], float(bw))
    ystart = min(cor[0, 1], cor[2, 1], 0.0)
    yend = max(cor[1, 1], cor[3, 1], float(bh))
    T = np.eye(3)
    T[0, 2] = -xstart
    T[1, 2] = -ystart
    return T, xstart, xend, ystart, yend


@dataclasses.dataclass
class PanImgTransform:
    """Flat-plane transform container (imgm::pan_img_transform,
    _img_manipulation.h:21-49): per-image chained homographies to the
    reference image's plane, global translation, panorama dims, and the
    BA state (rot, K) it seeds."""
    adj: np.ndarray                   # (N,N) upper-tri adjacency weights
    connectivity: np.ndarray          # (N,) connectivity score
    sizes: List[Tuple[int, int]]      # (h, w) per image
    img_to_pan: List[np.ndarray]      # H mapping image i -> flat panorama
    pan_to_img: List[np.ndarray]
    pan_hw: Tuple[int, int]           # (h, w), (nan-guarded at 30000)
    rot: List[np.ndarray]             # (3,3) per image, seeded identity
    K: List[np.ndarray]               # (3,3) per image, seeded diag(f,f,1)
    focal: float
    fast: bool
    center: int                       # BFS root = max-connectivity node


def bfs_order(adj_sym: np.ndarray, start: int) -> List[int]:
    """BFS traversal order over a symmetric adjacency (weights > 0)."""
    n = adj_sym.shape[0]
    seen = [False] * n
    order = [start]
    seen[start] = True
    q = [start]
    while q:
        u = q.pop(0)
        for v in range(n):
            if adj_sym[u, v] > 0 and not seen[v]:
                seen[v] = True
                order.append(v)
                q.append(v)
    return order


def shortest_paths(adj_sym: np.ndarray, start: int) -> List[List[int]]:
    """Per-node path from ``start`` using strongest-edge Dijkstra analog
    (util::path_table, _util.cpp:343-406): edge cost = 1/weight so strong
    links are preferred."""
    n = adj_sym.shape[0]
    INF = float("inf")
    dist = [INF] * n
    prev = [-1] * n
    dist[start] = 0.0
    done = [False] * n
    for _ in range(n):
        u, best = -1, INF
        for i in range(n):
            if not done[i] and dist[i] < best:
                u, best = i, dist[i]
        if u < 0:
            break
        done[u] = True
        for v in range(n):
            w = adj_sym[u, v]
            if w > 0 and not done[v]:
                nd = dist[u] + 1.0 / w
                if nd < dist[v]:
                    dist[v] = nd
                    prev[v] = u
    paths: List[List[int]] = []
    for i in range(n):
        if dist[i] == INF:
            paths.append([])
            continue
        p, cur = [], i
        while cur != -1:
            p.append(cur)
            cur = prev[cur]
        paths.append(list(reversed(p)))
    return paths


def calc_stitch_from_adj(adj: np.ndarray,
                         connectivity: np.ndarray,
                         sizes: Sequence[Tuple[int, int]],
                         hom_mat: np.ndarray,
                         focal: float,
                         fast: bool) -> PanImgTransform:
    """Chain homographies along strongest paths from the best-connected node
    and accumulate the canvas translation (imgm::calc_stitch_from_adj,
    _img_manipulation.cpp:281-390). ``hom_mat[i][j]`` maps points of image j
    into image i. Panorama dims are NaN-guarded at 30000 px."""
    n = adj.shape[0]
    adj_sym = adj + adj.T
    center = int(np.argmax(connectivity))
    paths = shortest_paths(adj_sym, center)

    # H chain: image i -> reference plane of `center`
    h_chain = [np.eye(3) for _ in range(n)]
    for i in range(n):
        p = paths[i]
        H = np.eye(3)
        # walk path center -> ... -> i; compose Hs mapping i into center
        for a, b in zip(p[:-1], p[1:]):
            H = H @ hom_mat[a, b]
        h_chain[i] = H

    # union bounding box over warped corners
    min_x = min_y = 0.0
    max_x, max_y = float(sizes[center][1]), float(sizes[center][0])
    for i in range(n):
        if i == center or connectivity[i] <= 0:
            continue
        h, w = sizes[i]
        cor = np.array([[0, 0], [0, h], [w, 0], [w, h]], dtype=np.float64)
        cor = apply_h_np(h_chain[i], cor)
        min_x = min(min_x, cor[:, 0].min())
        max_x = max(max_x, cor[:, 0].max())
        min_y = min(min_y, cor[:, 1].min())
        max_y = max(max_y, cor[:, 1].max())

    T = np.eye(3)
    T[0, 2] = -min_x
    T[1, 2] = -min_y
    width = max_x - min_x
    height = max_y - min_y
    if (not np.isfinite(width)) or (not np.isfinite(height)) \
            or width > 30000 or height > 30000:
        pan_hw = (-1, -1)  # NaN-guard (_img_manipulation.cpp:349-354)
    else:
        pan_hw = (int(np.ceil(height)), int(np.ceil(width)))

    img_to_pan = [T @ h_chain[i] for i in range(n)]
    pan_to_img = [np.linalg.inv(m) for m in img_to_pan]

    rot = [np.eye(3) for _ in range(n)]
    K = [np.diag([focal, focal, 1.0]) for _ in range(n)]
    return PanImgTransform(
        adj=adj, connectivity=connectivity, sizes=list(sizes),
        img_to_pan=img_to_pan, pan_to_img=pan_to_img, pan_hw=pan_hw,
        rot=rot, K=K, focal=focal, fast=fast, center=center)
