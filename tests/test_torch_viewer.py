"""The port's headless viewer and diagnose() against the JAX package's,
on the CPU.

Both PanoramaViewer classes drive one stub panorama (full resolution =
2x the preview) through the same zoom, crop, undo and redo steps, and
their state must be equal after each step; diagnose() of both packages
runs on the same 4 views.
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import pipeline as jpipeline
from simplepanorama_tpu import viewer as jviewer
import simplepanorama_tpu_torch as T
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import adjacency as tadj
from simplepanorama_tpu_torch import pipeline as tpipeline
from simplepanorama_tpu_torch import viewer as tviewer
from simplepanorama_tpu_torch.fixtures import fkh360_views

torch.set_num_threads(2)


class _StubPano:
    """get_preview / get_panorama(roi): the full resolution is the
    preview at 2x (tests/test_viewer.py's stub)."""

    def __init__(self, h, w):
        rng = np.random.default_rng(0)
        self.prev = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)

    def get_preview(self):
        return self.prev

    def get_panorama(self, roi=None):
        full = cv2.resize(self.prev, (self.prev.shape[1] * 2,
                                      self.prev.shape[0] * 2))
        if roi is None:
            return full
        x, y, w, h = roi
        return full[2 * y:2 * (y + h), 2 * x:2 * (x + w)]


def _state(v):
    return (v.crop_preview, list(v.crop_vec), v.ret_counter, v.zoom_val,
            v.current_zoom, v.display_width, v.display().shape)


_STEPS = [
    ("zoom_in", ()), ("zoom_in", ()), ("zoom_in", ()), ("zoom_out", ()),
    ("crop", ((100, 50, 500, 300),)), ("crop", ((400, 300, -200, -150),)),
    ("crop", ((10, 10, 50, 40), False)), ("crop", ((5000, 5000, 10, 10),)),
    ("undo_crop", ()), ("undo_crop", ()), ("redo_crop", ()),
    ("crop", ((0, 0, 30, 30),)), ("redo_crop", ()), ("undo_crop", ()),
    ("undo_crop", ()), ("undo_crop", ()), ("undo_crop", ()), ("zoom_out", ()),
    ("zoom_out", ()), ("redo_crop", ()), ("zoom_in", ()),
]


@pytest.mark.parametrize("hw", [(600, 1400), (500, 950), (400, 700)])
def test_viewer_state_matches_jax(hw, tmp_path):
    """zoom_ladder and every step of one sequence of zoom, crop
    (display and preview coordinates, a backwards drag, an empty
    intersection), undo and redo: equal return values and equal state
    after each step (ladder, rung, display width and shape, crop stack);
    then save(full_res=True) and save(full_res=False) write the same
    files as the JAX viewer's. Tolerance: exact."""
    pano = _StubPano(*hw)
    assert tviewer.zoom_ladder(hw[1]) == jviewer.zoom_ladder(hw[1])
    vj, vt = jviewer.PanoramaViewer(pano), T.PanoramaViewer(pano)
    assert _state(vt) == _state(vj)
    for name, args in _STEPS:
        assert getattr(vt, name)(*args) == getattr(vj, name)(*args), name
        assert _state(vt) == _state(vj), name
    for full in (True, False):
        pj, pt = str(tmp_path / f"j{full}.png"), str(tmp_path / f"t{full}.png")
        assert vj.save(pj, full_res=full) and vt.save(pt, full_res=full)
        assert np.array_equal(cv2.imread(pt), cv2.imread(pj))
    assert cv2.imread(str(tmp_path / "tTrue.png")).shape == \
        pano.get_panorama(vt.crop_preview).shape


def _jax_draws(n):
    """The JAX package's per-pair RANSAC uniforms (adjacency._pair_keys),
    for the port's draw hook."""
    master = jax.random.PRNGKey(0)

    def draws(i, j, n_iter, m):
        key = jax.random.fold_in(master, i * n + j)
        return np.array(jax.random.uniform(key, (n_iter, m)))
    return draws


def test_diagnose_matches_jax(tmp_path, monkeypatch):
    """diagnose() of both packages on 4 views of 320 px (the views of
    tests/test_torch_slice.py), the port on the CPU with the JAX
    package's RANSAC draws. Tolerance: equal image and keypoint counts,
    raw match counts, adjacency pattern and components (measured
    equal); adjacency values within 1e-3 and the focal estimate within
    1e-3 relative (measured 1.4e-5 and 2.7e-4)."""
    paths, _, _ = fkh360_views(4, 320, yaw_step_deg=20.0, hfov_deg=45.0,
                               roll_deg=3.0, out_dir=str(tmp_path))
    kw = dict(init_size=320, RANSAC_iterations=300)
    dj = jpipeline.diagnose(paths, JConfig(**kw))
    monkeypatch.setattr(tadj, "torch_pair_draws",
                        lambda seed, n, dev: _jax_draws(n))
    dt = tpipeline.diagnose(paths, TConfig(**kw), device="cpu")
    assert set(dt) == set(dj)
    assert dt["n_images"] == dj["n_images"] == 4
    assert dt["keypoint_counts"] == dj["keypoint_counts"]
    np.testing.assert_array_equal(dt["raw_match_counts"],
                                  np.asarray(dj["raw_match_counts"]))
    aj, at = np.asarray(dj["adjacency"]), np.asarray(dt["adjacency"])
    np.testing.assert_array_equal(at > 0, aj > 0)
    assert [list(c) for c in dt["components"]] == \
        [list(c) for c in dj["components"]]
    assert np.abs(at - aj).max() <= 1e-3
    assert abs(dt["focal_estimate"] / dj["focal_estimate"] - 1) <= 1e-3


def test_diagnose_default_device_is_the_card(tmp_path):
    """diagnose() defaults to cuda: without a card it raises before any
    work, as Panorama does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.diagnose([str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")])
