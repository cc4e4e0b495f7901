"""ops/gftt.py and the single-image ops/sift.extract_sift of the port
against the JAX package's, on the CPU, on tests/test_sift.py's cases."""

import numpy as np
import scipy.ndimage as ndi
import torch
import jax.numpy as jnp

from simplepanorama_tpu.ops import gftt as jgftt
from simplepanorama_tpu.ops import sift as jsift
from simplepanorama_tpu_torch.ops import gftt as tgftt
from simplepanorama_tpu_torch.ops import sift as tsift


def _rectangle():
    img = np.zeros((96, 96), np.float32)
    img[20:60, 30:70] = 200.0
    return ndi.gaussian_filter(img, 1.0)


def _texture(seed, shape):
    rng = np.random.default_rng(seed)
    return ndi.gaussian_filter(rng.uniform(0, 255, shape).astype(np.float32),
                               2.0) * 4


def _paired(xy_j, xy_t):
    """Largest distance from a JAX keypoint to its nearest port keypoint."""
    d = np.abs(xy_j[:, None, :] - xy_t[None, :, :]).max(-1)
    return d.min(1).max(), d.argmin(1)


def test_gftt_detect_matches_jax():
    """tests/test_sift.py's rectangle: the 16 strongest corners.
    Tolerance: the same valid count and corner positions (integer pixels),
    responses within 1e-3 relative of the JAX package's (Sobel and box
    sums in another float order); the four rectangle corners within 3 px
    (test_sift's bound)."""
    img = _rectangle()
    xj, rj, vj = jgftt.gftt_detect(jnp.asarray(img), jnp.array([96, 96]),
                                   max_corners=16)
    xt, rt, vt = tgftt.gftt_detect(torch.from_numpy(img), (96, 96),
                                   max_corners=16)
    vj, vt = np.asarray(vj), vt.numpy()
    assert vj.sum() == vt.sum() > 0
    pj, pt = np.asarray(xj)[vj], xt.numpy()[vt]
    assert sorted(map(tuple, pj)) == sorted(map(tuple, pt))
    rj = dict(zip(map(tuple, pj), np.asarray(rj)[vj]))
    for p, r in zip(map(tuple, pt), rt.numpy()[vt]):
        assert abs(r - rj[p]) <= 1e-3 * abs(rj[p])
    for cx, cy in [(30, 20), (69, 20), (30, 59), (69, 59)]:
        assert np.linalg.norm(pt - np.array([cx, cy]), axis=1).min() < 3.0


def test_gftt_sift_matches_jax():
    """tests/test_sift.py's shifted texture pair, 128 corners each.
    Tolerance: the same corners; descriptors within 2e-3 of the JAX
    package's (gradients are rounded to bfloat16 on both sides); and
    test_sift's own check, > 40% of the shifted image's descriptors
    matched above 0.9."""
    base = _texture(9, (128, 160))
    out = {}
    for name, img in (("a", base[:, :128].copy()),
                      ("b", base[:, 24:152].copy())):
        fj = jgftt.gftt_sift(jnp.asarray(img), jnp.array([128, 128]),
                             max_corners=128)
        ft = tgftt.gftt_sift(torch.from_numpy(img), (128, 128),
                             max_corners=128)
        vj, vt = np.asarray(fj.valid), ft.valid.numpy()
        assert vj.sum() == vt.sum() > 10
        np.testing.assert_array_equal(ft.xy.numpy()[vt], np.asarray(fj.xy)[vj])
        assert np.abs(ft.desc.numpy()[vt] - np.asarray(fj.desc)[vj]).max() \
            <= 2e-3
        out[name] = ft.desc.numpy()[vt]
    assert ((out["a"] @ out["b"].T).max(1) > 0.9).mean() > 0.4


def test_extract_sift_matches_jax():
    """The single-image extract_sift on test_sift's blob image and on a
    smoothed texture. Tolerance (as the batch test in
    test_torch_modules.py): the same number of valid keypoints, every JAX
    keypoint within 1e-2 px of a port keypoint; on the texture, paired
    descriptors within 2e-3 (measured 1.8e-4); on the blobs, the four
    blobs found within 1 px (test_sift's bound). A blob's descriptors are
    not compared: a radially symmetric blob has no dominant orientation,
    and a last-bit difference picks another histogram peak (measured on
    2 of its 4 keypoints)."""
    yy, xx = np.mgrid[0:128, 0:128]
    blobs = [(40, 40, 3, 200), (80, 90, 5, 180), (60, 20, 2, 150),
             (100, 50, 4, 120)]
    img = np.zeros((128, 128), np.float32)
    for (y, x, s, a) in blobs:
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    for name, im in (("blobs", np.clip(img, 0, 255).astype(np.float32)),
                     ("texture", _texture(5, (96, 96)))):
        hw = np.array(im.shape, np.int32)
        fj = jsift.extract_sift(jnp.asarray(im), jnp.asarray(hw), max_kp=64)
        ft = tsift.extract_sift(torch.from_numpy(im),
                                torch.from_numpy(hw.astype(np.int64)),
                                max_kp=64)
        vj, vt = np.asarray(fj.valid), ft.valid.numpy()
        assert vj.sum() == vt.sum() >= 4
        xj, xt = np.asarray(fj.xy)[vj], ft.xy.numpy()[vt]
        dist, nn = _paired(xj, xt)
        assert dist <= 1e-2
        if name == "texture":
            dj = np.asarray(fj.desc)[vj]
            assert np.abs(ft.desc.numpy()[vt][nn] - dj).max() <= 2e-3
        else:
            for (y, x, _, _) in blobs:
                assert np.linalg.norm(xt - np.array([x, y]), axis=1).min() \
                    < 1.0
