"""Synthetic input for the tests and the GPU smoke run.

``fkh360_views`` cuts pinhole views with known yaw and focal out of the
360-degree equirectangular fixture ``tests/data/ref_fresh/FKH360_300.jpg``
(W px per 2*pi radians). Consecutive views overlap by hfov - yaw_step, so
a loop of 360/yaw_step views closes the circle. ``cut_grid`` and
``maze_grid`` make seam-style cut graphs for the min-cut solvers, and
``max_flow_value`` their exact max-flow value. ``lm_trial_problem`` makes
a bundle-adjustment problem for the LM trial's kernels.
"""

from __future__ import annotations

import math
import os
import pathlib
from typing import List, Tuple

import cv2
import numpy as np

FKH360 = (pathlib.Path(__file__).resolve().parent.parent
          / "tests" / "data" / "ref_fresh" / "FKH360_300.jpg")


def fkh360_views(n: int, size: int, yaw_step_deg: float = 30.0,
                 hfov_deg: float = 60.0, out_dir: str = ".",
                 roll_deg: float = 0.0
                 ) -> Tuple[List[str], List[float], float]:
    """Render ``n`` square ``size``-px pinhole views at yaws
    0, yaw_step, 2*yaw_step, ... degrees into ``out_dir`` (PNG). With
    ``roll_deg``, view k is also rolled about its optical axis by
    +roll_deg (k even) or -roll_deg (k odd): pure-yaw pairs leave the
    homography focal estimate (geometry/focal.py) degenerate, a small
    roll makes it well posed.

    Returns (paths, yaws in degrees, true focal in px). ``size`` must be
    >= 300: the loader rejects smaller images."""
    if size < 300:
        raise ValueError("views must be >= 300 px (io.clamp_to_init_size)")
    pano = cv2.imread(str(FKH360), cv2.IMREAD_COLOR)
    if pano is None:
        raise FileNotFoundError(FKH360)
    Hp, Wp = pano.shape[:2]
    px_per_rad = Wp / (2 * math.pi)
    # wrap a few columns so bilinear taps at the 0/2pi seam stay inside
    src = np.concatenate([pano, pano[:, :4]], axis=1)
    f = (size / 2.0) / math.tan(math.radians(hfov_deg) / 2.0)
    c = (size - 1) / 2.0
    v, u = np.mgrid[0:size, 0:size].astype(np.float64)
    os.makedirs(out_dir, exist_ok=True)
    paths, yaws = [], []
    for k in range(n):
        yaw = k * yaw_step_deg
        r = math.radians(roll_deg if k % 2 == 0 else -roll_deg)
        xc, yc = (u - c) / f, (v - c) / f
        x = math.cos(r) * xc - math.sin(r) * yc
        y = math.sin(r) * xc + math.cos(r) * yc
        lat = np.arctan2(y, np.sqrt(x * x + 1.0))
        lon = np.arctan2(x, 1.0) + math.radians(yaw)
        map_x = np.mod(lon * px_per_rad, Wp).astype(np.float32)
        map_y = (Hp / 2.0 + lat * px_per_rad).astype(np.float32)
        view = cv2.remap(src, map_x, map_y, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REPLICATE)
        p = os.path.join(out_dir, f"view_{k:02d}.png")
        cv2.imwrite(p, view)
        paths.append(p)
        yaws.append(yaw)
    return paths, yaws, f


def cut_grid(H: int, W: int, seed: int,
             hole: Tuple[int, int, int, int]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Random 4-connected cut graph (cap_h, cap_v, excess, node):
    capacities uniform in [0.1, 1), the rows hole[0]:hole[1] and columns
    hole[2]:hole[3] cut out of the node set, t-links of 5000 to the source
    in the first column and to the sink in the last. At 48x160, seed 7
    and hole (10, 20, 40, 70) it is the grid of tests/test_graphcut.py."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    wv = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    node = np.ones((H, W), bool)
    node[hole[0]:hole[1], hole[2]:hole[3]] = False
    exc = np.zeros((H, W), np.float32)
    exc[:, 0] = 5000.0
    exc[:, -1] = -5000.0
    return wh, wv, exc, node


def maze_grid(H: int, W: int, seed: int, period: int = 4
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A serpentine maze as a cut graph (cap_h, cap_v, excess, node):
    corridors of ``period - 1`` rows between wall rows (rows period - 1,
    2 * period - 1, ... are not nodes) with a one-cell gap at the right end
    of every even wall and the left end of every odd one, so the only path
    runs the full width of every corridor in turn. Capacities uniform in
    [0.1, 1); t-links of 5000 to the source at the first column of the
    first corridor and to the sink at the far end of the last one. Sink
    distances run to about H * W / period and cross every tile a row of
    corridors passes."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    wv = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    node = np.ones((H, W), bool)
    walls = list(range(period - 1, H, period))
    for i, y in enumerate(walls):
        node[y] = False
        node[y, W - 1 if i % 2 == 0 else 0] = True
    exc = np.zeros((H, W), np.float32)
    exc[:min(period - 1, H), 0] = 5000.0
    last = len([y for y in walls if y < H - 1])   # corridors before the last
    y0 = last * period
    exc[y0:H, W - 1 if last % 2 == 0 else 0] = -5000.0
    exc[~node] = 0.0
    return wh, wv, exc, node


def max_flow_value(wh: np.ndarray, wv: np.ndarray, excess: np.ndarray,
                   node: np.ndarray, scale: int = 10000) -> float:
    """scipy's exact max-flow value of a cut graph (the arrays of
    ``cut_grid``), on capacities rounded to 1/scale: the oracle the
    min-cut solvers' tests hold their cut values to."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow
    H, W = wh.shape
    n = H * W
    idx = np.arange(n).reshape(H, W)
    rows, cols, caps = [], [], []

    def add(u, v, c):
        c = np.round(c * scale).astype(np.int64)
        keep = c > 0
        rows.append(u[keep])
        cols.append(v[keep])
        caps.append(c[keep])
    h = node[:, :-1] & node[:, 1:]
    add(idx[:, :-1][h], idx[:, 1:][h], wh[:, :-1][h])
    add(idx[:, 1:][h], idx[:, :-1][h], wh[:, :-1][h])
    v = node[:-1] & node[1:]
    add(idx[:-1][v], idx[1:][v], wv[:-1][v])
    add(idx[1:][v], idx[:-1][v], wv[:-1][v])
    src = node & (excess > 0)
    snk = node & (excess < 0)
    add(np.full(src.sum(), n), idx[src], excess[src])
    add(idx[snk], np.full(snk.sum(), n + 1), -excess[snk])
    g = csr_matrix((np.concatenate(caps).astype(np.int32),
                    (np.concatenate(rows), np.concatenate(cols))),
                   shape=(n + 2, n + 2))
    return maximum_flow(g, n, n + 1).flow_value / scale


def lm_trial_problem(n_cams: int, M: int, seed: int = 0, device="cpu",
                     inactive: int = 0, outside: bool = False,
                     idle_camera: bool = False, reach: int = 2):
    """A bundle-adjustment problem of ``n_cams`` camera slots and ``M``
    match slots: cameras on a yaw arc (camera 0 at the identity rotation,
    so its rotation is frozen), focal 500, matches from the BA model
    H(i, j) = K R_i^T R_j K^-1 plus 0.3 px noise between each camera and
    its next ``reach`` (both directions; the yaw step at most 0.6 /
    ``reach`` rad), filling 7/8 of the slots. The last
    ``inactive`` cameras are inactive (their matches too); ``outside``
    names camera ``n_cams``, outside the table, instead of the last
    camera as the first camera of every other match of that camera (the
    pair tables clamp it back to the last camera, as torch.clamp does;
    the camera system and the back-substitution leave that side out);
    ``idle_camera`` leaves the last active camera with no match, so every
    trial's system is singular. Returns (ba.CamState,
    the start: focal 5% high, rotations 0.02 rad off, b = t; ba.BAData
    with its pair tables; cam_active (bool))."""
    import torch
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.geometry.rotation import rodrigues
    rng = np.random.default_rng(seed)
    f = 500.0
    n_live = n_cams - inactive
    step = min(0.3, 2 * math.pi / n_cams, 0.6 / reach)
    rv = np.array([[0.01 * i, step * i, -0.005 * i] for i in range(n_cams)],
                  np.float32)
    R = [rodrigues(torch.from_numpy(v)).double().numpy() for v in rv]
    K = np.diag([f, f, 1.0])
    n_matched = n_live - (1 if idle_camera else 0)
    pairs = [(i, j) for i in range(n_cams) for j in range(n_cams)
             if 0 < abs(i - j) <= reach and i < n_matched + inactive
             and j < n_matched + inactive
             and (i < n_matched) == (j < n_matched)]
    n_valid = M * 7 // 8
    per = np.bincount(rng.integers(0, len(pairs), n_valid),
                      minlength=len(pairs))
    mi, mj, qs, ts = [], [], [], []
    for (i, j), k in zip(pairs, per):
        H = K @ R[i].T @ R[j] @ np.linalg.inv(K)
        t = rng.uniform(-200, 200, (k, 2))
        th = np.concatenate([t, np.ones((k, 1))], 1) @ H.T
        qs.append(th[:, :2] / th[:, 2:3] + rng.normal(0, 0.3, (k, 2)))
        ts.append(t)
        mi += [i] * k
        mj += [j] * k
    mi = np.array(mi + [0] * (M - n_valid), np.int64)
    mj = np.array(mj + [0] * (M - n_valid), np.int64)
    if outside:
        last = np.flatnonzero(mi[:n_valid] == n_cams - 1)
        mi[last[::2]] = n_cams
    pad = np.zeros((M - n_valid, 2))
    T = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    data = ba.with_pair_tables(ba.BAData(
        mi=T(mi), mj=T(mj),
        q=T(np.concatenate(qs + [pad]), torch.float32),
        t=T(np.concatenate(ts + [pad]), torch.float32),
        m_valid=T(np.arange(M) < n_valid), pi=None, pj=None, mp=None))
    rot0 = rv + rng.normal(0, 0.02, rv.shape).astype(np.float32)
    rot0[0] = 0.0
    cams = ba.CamState(T(np.full(n_cams, f * 1.05), torch.float32),
                       T(np.zeros((n_cams, 2)), torch.float32),
                       T(rot0), data.t.clone())
    return cams, data, T(np.arange(n_cams) < n_live)
