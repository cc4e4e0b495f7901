"""Parity of the port's full-res render and gain compensation with the
JAX package, on the CPU.

The full-res render is held against the JAX package's single-device
streaming render (render_full_dev with force_single=True) on the
StitchParams of one known-geometry StitchResult (no SIFT, RANSAC or BA):
two crops of the 360-degree fixture as the preview images, the same
crops upscaled 2x as the full-res ones. The port renders from a copy of
the JAX package's preview state (seams, intensity fields, gains), so the
comparison sees the render alone.
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplepanorama_tpu as J
from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import stitcher as jstitcher
from simplepanorama_tpu.config import Blending as JBlending
from simplepanorama_tpu.render import compose as jcomp
from simplepanorama_tpu.render import fullres as jfull
from simplepanorama_tpu.stitch import StitchResult as JStitchResult
import simplepanorama_tpu_torch as T
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import stitcher as tstitcher
from simplepanorama_tpu_torch.config import Blending as TBlending
from simplepanorama_tpu_torch.convert import (compose_state_from_numpy,
                                              stitch_result_from_numpy)
from simplepanorama_tpu_torch.fixtures import FKH360, fkh360_views
from simplepanorama_tpu_torch.pipeline import crop_roi
from simplepanorama_tpu_torch.render import compose as tcomp
from simplepanorama_tpu_torch.render import fullres as tfull

torch.set_num_threads(2)


def _views():
    """Two 136x200 crops of the fixture with a relative yaw of 0.35 rad,
    K and R as the BA would hand them over, and the crops at 2x."""
    pano = cv2.imread(str(FKH360))
    imgs = [pano[60:196, 0:200], pano[60:196, 900:1100]]
    f = 180.0
    Ks, Rs = [], []
    for k, im in enumerate(imgs):
        h, w = im.shape[:2]
        Ks.append(np.array([[f, 0, w // 2], [0, f, h // 2], [0, 0, 1.0]]))
        a = 0.35 * k
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    full = [cv2.resize(im, (400, 272), interpolation=cv2.INTER_LINEAR)
            for im in imgs]
    res = JStitchResult(
        rot=np.stack(Rs), K=np.stack(Ks), adj=np.array([[0, 0.5], [0, 0]]),
        connectivity=np.array([1, 1]), order=[(0, -1), (1, 0)],
        nodes=[0, 1], center=0, sizes=[im.shape[:2] for im in imgs])
    return imgs, full, res


@pytest.fixture(scope="module")
def preview_params():
    """JAX set_config per (cut, gain), and the port's copy of it."""
    imgs, full, res = _views()
    out = {}
    for cut in (False, True):
        for gain in (False, True):
            pj = jstitcher.set_config(
                res, imgs, JConfig(cut=cut, gain_compensation=gain))
            pt = tstitcher.StitchParams(
                res=stitch_result_from_numpy(res), rot=np.array(pj.rot),
                proj_kind=pj.proj_kind, scale=pj.scale,
                state=compose_state_from_numpy(pj.state),
                gains=None if pj.gains is None else np.array(pj.gains))
            out[cut, gain] = (pj, pt)
    return full, out


def _agree(a, b, max_frac, max_mean, tol=3):
    """tests/test_fullres.py:57-65: the share of pixels that differ by
    more than ``tol`` levels, and the mean absolute difference."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    frac = float((diff > tol).mean())
    mean = float(diff.mean())
    assert frac < max_frac, f"{frac:.4%} pixels differ by >{tol}"
    assert mean < max_mean, f"mean abs diff {mean:.3f}"
    return frac, mean


@pytest.mark.parametrize("gain", [False, True])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("blend", ["MULTI_BLEND", "SIMPLE_BLEND",
                                   "NO_BLEND"])
def test_render_full_matches_jax(preview_params, blend, cut, gain):
    """render_full of the port against JAX render_full_dev(force_single=
    True) on one preview state. Tolerance: fewer than 0.01% of pixels
    more than 1 level apart and a mean difference under 0.01 levels,
    far tighter than tests/test_fullres.py's _agree (1% over 3 levels,
    1.5). Measured over all 12 cases: no pixel more than 1 level apart,
    mean at most 1.4e-4 (float sums in another order flip a rounding at
    the uint8 cast)."""
    full, params = preview_params
    pj, pt = params[cut, gain]
    kw = dict(cut=cut, gain_compensation=gain)
    cj = dataclasses.replace(JConfig(**kw), blend=JBlending[blend])
    ct = dataclasses.replace(TConfig(**kw), blend=TBlending[blend])
    oj = np.asarray(jfull.render_full_dev(pj, cj, full, force_single=True))
    ot = tstitcher.render_full(pt, ct, full)
    _agree(oj, ot, max_frac=1e-4, max_mean=0.01, tol=1)


def test_chunked_equals_unchunked(preview_params, monkeypatch):
    """A 1-byte budget makes every chunk one image: the canvas folds must
    not depend on the chunking. Tolerance: identical panoramas (measured
    identical: each image's contribution is computed the same way)."""
    full, params = preview_params
    _, pt = params[True, True]
    cfg = TConfig(cut=True, gain_compensation=True)
    one = tstitcher.render_full(pt, cfg, full)
    monkeypatch.setattr(tfull, "_CHUNK_BUDGET", 1)
    chunked = tstitcher.render_full(pt, cfg, full)
    assert np.array_equal(one, chunked)


def test_gain_matches_jax(preview_params):
    """compose.gain_dev of the port against the JAX package's on the same
    packed blocks. Tolerance: gains within 1e-4 relative (measured
    9.6e-8: the overlap sums are float32 products in another order)."""
    _, params = preview_params
    pj, pt = params[False, True]
    sj = pj.state
    gj = jcomp.gain_dev(sj.imgs, sj.masks, sj.offs, tuple(sj.canvas_hw),
                        pj.res.adj)
    st = pt.state
    gt = tcomp.gain_dev(st.imgs, st.masks, st.offs, st.canvas_hw, pt.res.adj)
    assert gt.shape == (2,) and np.all(np.isfinite(gt)) and np.all(gt > 0)
    assert np.max(np.abs(gt / gj - 1.0)) <= 1e-4


@pytest.mark.parametrize("cubic", [True, False])
def test_resize_pieces_match_jax(cubic):
    """_resize_matrix and _upsample_block (cv2-aligned cubic and linear
    interpolation matrices) against the JAX package's, at ratios below
    and above 1 and one with zero rows past the input. Tolerance 1e-5
    absolute (measured: matrices 1.2e-7, the same zero rows, blocks
    2.4e-7 on 0..1 data: float32 sums in another order)."""
    rng = np.random.default_rng(2)
    block = rng.uniform(0, 1, (24, 40)).astype(np.float32)
    for n_out, n_in, ratio in ((50, 24, 0.48), (13, 40, 3.1), (64, 24, 0.5)):
        mj = np.asarray(jfull._resize_matrix(n_out, n_in, np.float32(ratio),
                                             cubic=cubic))
        mt = tfull._resize_matrix(n_out, n_in, float(np.float32(ratio)),
                                  cubic=cubic).numpy()
        assert np.abs(mt - mj).max() <= 1e-5
        assert np.array_equal((mt == 0).all(1), (mj == 0).all(1))
    uj = np.asarray(jfull._upsample_block(jnp.asarray(block), (56, 88),
                                          (np.float32(0.43),
                                           np.float32(0.45)), cubic))
    ut = tfull._upsample_block(torch.from_numpy(block), (56, 88),
                               (float(np.float32(0.43)),
                                float(np.float32(0.45))), cubic).numpy()
    assert np.abs(ut - uj).max() <= 1e-5


@pytest.mark.parametrize("roi", [(10, 5, 40, 30), (0, 0, 1000, 1000),
                                 (33, 17, 1, 1)])
def test_crop_roi_matches_jax_arithmetic(roi):
    """pipeline.crop_roi against the JAX get_panorama arithmetic
    (pipeline.py:228-237) written out: exact."""
    full = np.arange(90 * 140 * 3, dtype=np.int64).reshape(90, 140, 3) \
        .astype(np.uint8)
    ph, pw = 44, 70
    fh, fw = full.shape[:2]
    sx, sy = fw / pw, fh / ph
    x, y, w, h = roi
    want = full[max(0, int(y * sy)):min(fh, int((y + h) * sy)),
                max(0, int(x * sx)):min(fw, int((x + w) * sx))]
    got = crop_roi(full, (ph, pw), roi)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_get_panorama_matches_jax(tmp_path):
    """Panorama.get_panorama of both packages on two 640-px views
    (preview at init_size 320) with their true geometry put in place of
    the BA result (cut, gain): the full-res load, render and cache.
    Tolerance: same shape, under 0.01% of pixels more than 1 level apart
    and a mean difference under 0.01 (measured: no pixel more than 1
    level apart, mean 6.1e-4). The cached panorama is returned again,
    an ROI is its crop_roi, and set_config clears the cache."""
    paths, yaws, f = fkh360_views(2, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                                  out_dir=str(tmp_path))
    fp = f * 320 / 640
    K = np.array([[fp, 0, 160], [0, fp, 160], [0, 0, 1.0]])
    Rs = []
    for yaw in yaws:
        a = np.radians(yaw)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    res = JStitchResult(rot=np.stack(Rs), K=np.stack([K, K]),
                        adj=np.array([[0, 0.5], [0, 0]]),
                        connectivity=np.array([1, 1]),
                        order=[(0, -1), (1, 0)], nodes=[0, 1], center=0,
                        sizes=[(320, 320), (320, 320)])
    kw = dict(cut=True, init_size=320, gain_compensation=True)
    pj = J.Panorama(paths)
    pj.result = res
    pj.set_config(JConfig(**kw))
    pt = T.Panorama(paths, device="cpu")
    pt.result = stitch_result_from_numpy(res)
    pt.set_config(TConfig(**kw))
    full = pt.get_panorama()
    _agree(np.asarray(pj.get_panorama()), full, max_frac=1e-4,
           max_mean=0.01, tol=1)
    assert pt.get_panorama() is full
    roi = (30, 20, 200, 90)
    assert np.array_equal(pt.get_panorama(roi), crop_roi(
        full, pt.get_preview().shape[:2], roi))
    pt.set_config(TConfig(**kw))
    assert pt._full_pano is None
