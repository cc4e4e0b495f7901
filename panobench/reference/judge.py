"""The comparison that decides ``correct``.

Each panorama the program made is held against the true geometry
(``truth``), which the reference works out from the drawn parameters of
its set alone. The numbers compared, each the worst reading over the
panoramas judged, against a limit of its own
(``panobench/limits/<cell>.json``):

- ``missing_views``: views the program left out of the panorama
  (features and matching); every view of a set overlaps its neighbours.
- ``reg_px``: the worst neighbouring pair's median distance, in
  working-resolution px, between where the program's cameras put a view's
  pixels in its neighbour and where they truly fall (the BA).
- ``reg_px_median``: the same distance's median over the pairs.
- ``focal_err``: the median over the views of ``|f / f_true - 1|`` (the
  BA's focal lengths).
- ``preview_gap``: 1 - NCC between the preview's luma and the true
  panorama's on the program's canvas, over the pixels some view truly
  sees (warp, exposure, seams, blending; a hole counts as black). Each
  canvas pixel shows the pixel of the view that the program's cameras
  put there, and the reference gives that view pixel its true colour:
  this judges the compositing; ``reg_px``, ``reg_px_median`` and
  ``focal_err`` judge the cameras against the truth.
- ``full_gap``: the same for the full-resolution panorama, resized to
  the preview's canvas (the full-res render), where the cell exports.
- ``seam_defect``: the share of covered canvas pixels that the seam
  masks do not give to exactly one image (the graph cut's labels).
- ``seam_cut_excess``: the last image's seam cut against the minimum
  cut of its graph, which a plain max-flow finds (``seams``): 0 for a
  minimum cut (the min-cut kernels).

The program's outputs are read in the conventions its ``Panorama``
states: ``result.K`` has its principal point given from the far corner
(the camera's pixel matrix has ``cx = w - K[0, 2]``, ``cy = h - K[1, 2]``);
``stitch_params.rot`` are the cameras the canvas was drawn with;
the canvas starts at ``state.min_xy`` in units of ``stitch_params.scale``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import cv2
import numpy as np
import torch

from panobench.reference import seams, truth

# working px inside a view's border that the preview is judged on: the
# program erodes each footprint by 4 px and blends across the seams
MARGIN_PX = 8.0

NUMBERS = ("missing_views", "reg_px", "reg_px_median", "focal_err",
           "preview_gap", "full_gap", "seam_defect", "seam_cut_excess")


def pixel_K(K: np.ndarray, h: int, w: int) -> np.ndarray:
    Ka = np.array(K, np.float64)
    Ka[0, 2] = w - K[0, 2]
    Ka[1, 2] = h - K[1, 2]
    return Ka


def cameras(out: dict, n_views: int):
    """The program's cameras by view index (NaN where not connected)."""
    R = np.full((n_views, 3, 3), np.nan)
    K = np.full((n_views, 3, 3), np.nan)
    for l, g in enumerate(out["nodes"]):
        h, w = out["sizes"][l]
        R[g] = out["rot"][l]
        K[g] = pixel_K(out["K"][l], h, w)
    return R, K


def judge_cameras(out: dict, views) -> Dict[str, float]:
    n = len(views.paths)
    R_true = views.R
    R, K = cameras(out, n)
    work = int(out["sizes"][0][1])
    K_true = truth.true_K(views.size, views.hfov_deg, work)
    reg = truth.registration_px(R, K, R_true, K_true, work,
                                truth.loop_pairs(n, views.yaw_step_deg))
    got = [g for g in range(n) if np.isfinite(R[g]).all()]
    focal = [abs(K[g][0, 0] / K_true[0, 0] - 1.0) for g in got]
    return {"missing_views": float(n - len(out["nodes"])),
            "reg_px": reg["worst"], "reg_px_median": reg["median"],
            "focal_err": float(np.median(focal)) if focal else math.inf}


def judge_images(out: dict, views, src: torch.Tensor) -> Dict[str, float]:
    """preview_gap, full_gap (where a full-res panorama was kept) and
    seam_defect (where seams were kept) of one panorama."""
    n = len(views.paths)
    R_true = views.R
    R, K = cameras(out, n)
    got = [g for g in range(n) if np.isfinite(R[g]).all()]
    res: Dict[str, float] = {}
    if len(got) < 2:
        res["preview_gap"] = math.inf
        if out.get("full") is not None:
            res["full_gap"] = math.inf
        return res
    work = int(out["sizes"][0][1])
    K_true = truth.true_K(views.size, views.hfov_deg, work)
    prev = out["preview"]
    ref, seen = truth.reference_panorama(
        src, prev.shape[:2], out["min_xy"], out["scale"], R, K, R_true,
        K_true, work, MARGIN_PX)
    g_ref = truth.gray(ref)
    dev = src.device
    res["preview_gap"] = truth.ncc_gap(
        truth.gray(torch.from_numpy(prev).to(dev)), g_ref, seen)
    full = out.get("full")
    if full is not None:
        small = cv2.resize(full, (prev.shape[1], prev.shape[0]),
                           interpolation=cv2.INTER_AREA)
        res["full_gap"] = truth.ncc_gap(
            truth.gray(torch.from_numpy(small).to(dev)), g_ref, seen)
    if out.get("seams") is not None:
        res["seam_defect"] = truth.seam_defect(
            out["seams"], out["masks"], out["offs"], out["canvas_hw"])
    return res


def judge_seam_cut(out: dict, draw: float) -> Dict[str, float]:
    """seam_cut_excess of one panorama's last cut (``seams.last_cut``;
    ``draw`` picks the part of its overlap that is solved)."""
    r = seams.last_cut(out["imgs"], out["masks"], out["seams"], out["offs"],
                       out["seq"], out["canvas_hw"], draw)
    return {"seam_cut_excess": r.pop("cut_excess"), "seam_cut": r}


def verdict(readings: List[Dict[str, float]],
            limits: Dict[str, float]) -> Dict[str, dict]:
    """The worst reading of each limited number over the panoramas
    judged, beside its limit."""
    checks = {}
    for name in NUMBERS:
        vals = [r[name] for r in readings if name in r]
        if name in limits and vals:
            worst = max(vals)
            checks[name] = {"value": worst, "limit": limits[name],
                            "ok": bool(worst <= limits[name])}
    return checks
